"""VGGT (Visual Geometry Grounded Transformer): feed-forward camera pose and
dense geometry from unposed frames, port of the JAX ``models/vggt.py``.

Parity targets (the reference's vggt/models/aggregator.py:24-331,
vggt/layers/vision_transformer.py, vggt/models/vggt.py:18-97,
vggt/heads/camera_head.py:19-157, dpt_head.py:21-497, head_act.py and
vggt/utils/pose_enc.py):

- ``Aggregator``: DINOv2 ViT-L/14 patch tokens (cls + 4 register tokens,
  the position table resized bicubically when the grid is not the
  pretraining one), one camera token and 4 register tokens per frame (the
  first frame's set differs from the others'), then alternating frame and
  global attention as the two reshapes [B*S, T, C] <-> [B, S*T, C], with
  per-head qk LayerNorm (eps 1e-5), 2D RoPE (special tokens at position 0,
  the identity) and LayerScale. Only the layers the heads read are kept;
- ``CameraHead``: 4 adaLN iterations over a 4-block trunk at 2C; the fov
  channels pass a ReLU;
- ``DPTHead``: the 4-level resize pyramid, FeatureFusionBlocks coarse to
  fine, align-corners bilinear upsampling and the activation split. It
  runs ``FRAMES_CHUNK`` frames at a time (8, as the reference's heads
  do): each frame's output does not depend on the others', and 49 frames
  of 128-channel maps at 518 x 518 alone would take 6.7 GB;
- ``TrackHead`` (``models/vggt_track``), when query points are given.

Attention is ``F.scaled_dot_product_attention`` (the JAX package computes
an einsum; no Pallas kernel is involved). On a CUDA tensor it may use the
flash, memory-efficient or cuDNN backends but never the math one: the
global attention over 49 frames at 518 x 518 spans 67,326 tokens, whose
score matrix the math backend would materialise (290 GB), so a call that
no fused backend takes raises instead.

The state_dict has facebook/VGGT-1B's keys (``tests/torch_vggt_mirror.py``
is their record; the DINOv2 ``mask_token`` is there, unused, so that
checkpoint loads strictly); ``convert.vggt_from_numpy`` carries the JAX
model's params across and ``init_vggt_params`` gives seeded random weights
with the laws of the JAX package's flax initialisers.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.interp import resize_bicubic_torch
from ..ops.quat import quat_normalize, quat_to_rotmat
from ..utils.device import resolve_device

RESNET_MEAN = (0.485, 0.456, 0.406)
RESNET_STD = (0.229, 0.224, 0.225)
FRAMES_CHUNK = 8                 # frames per DPT-head pass


@dataclasses.dataclass(frozen=True)
class VGGTConfig:
    img_size: int = 518
    patch_size: int = 14
    embed_dim: int = 1024          # aggregator block width
    depth: int = 24                # frame/global block pairs
    num_heads: int = 16
    mlp_ratio: float = 4.0
    num_register_tokens: int = 4
    qk_norm: bool = True
    rope_freq: float = 100.0
    layerscale_init: float = 0.01
    # the DINOv2 patch-embed ViT (vit_large)
    vit_embed_dim: int = 1024
    vit_depth: int = 24
    vit_num_heads: int = 16
    vit_layerscale_init: float = 1.0
    # heads
    camera_trunk_depth: int = 4
    camera_iterations: int = 4
    intermediate_layers: Tuple[int, int, int, int] = (4, 11, 17, 23)
    dpt_features: int = 256
    dpt_out_channels: Tuple[int, int, int, int] = (256, 512, 1024, 1024)
    enable_depth_head: bool = True
    enable_point_head: bool = True
    # track head (vggt/heads/track_head.py:18-29)
    enable_track_head: bool = False
    track_features: int = 128
    track_iters: int = 4
    track_corr_levels: int = 7
    track_corr_radius: int = 4
    track_depth: int = 6
    track_hidden: int = 384
    track_virtual: int = 64
    track_num_heads: int = 8

    @property
    def vit_pos_grid(self) -> int:
        # sqrt of the pretraining position table's patch count (518/14)
        return self.img_size // self.patch_size


# ---------------------------------------------------------------- layers

def apply_rope_2d(t: torch.Tensor, pos: torch.Tensor,
                  freq: float) -> torch.Tensor:
    """2D RoPE (vggt/layers/rope.py:62-188): the head dim splits into a
    vertical half rotated by pos y and a horizontal half by pos x, each
    NeoX rotate-half with its angles repeated twice. t [B,H,N,hd], pos
    [N,2] float (y, x); position 0 is the identity."""
    hd = t.shape[-1]
    half = hd // 2
    quarter = half // 2
    exponents = torch.arange(0, half, 2, dtype=torch.float32,
                             device=t.device) / half
    inv_freq = 1.0 / (freq ** exponents)                     # [quarter]

    def rotate(x, p):
        ang = p[:, None] * inv_freq
        ang = torch.cat([ang, ang], -1)                      # [N, half]
        x1, x2 = x[..., :quarter], x[..., quarter:]
        return x * ang.cos() + torch.cat([-x2, x1], -1) * ang.sin()

    return torch.cat([rotate(t[..., :half], pos[:, 0]),
                      rotate(t[..., half:], pos[:, 1])], -1)


def fused_sdpa(q, k, v):
    """``scaled_dot_product_attention`` that on CUDA tensors may not take
    the math backend (see the module's docstring)."""
    if q.is_cuda:
        from torch.nn.attention import SDPBackend, sdpa_kernel
        ctx = sdpa_kernel([SDPBackend.FLASH_ATTENTION,
                           SDPBackend.EFFICIENT_ATTENTION,
                           SDPBackend.CUDNN_ATTENTION])
    else:
        ctx = contextlib.nullcontext()
    with ctx:
        return F.scaled_dot_product_attention(q, k, v)


class Attention(nn.Module):
    """vggt/layers/attention.py:21-77: fused qkv, optional per-head qk
    LayerNorm and 2D RoPE, softmax(QK^T/sqrt(hd))V."""

    def __init__(self, dim: int, heads: int, qk_norm: bool = False,
                 rope_freq: Optional[float] = None, ln_eps: float = 1e-5):
        super().__init__()
        self.heads = heads
        hd = dim // heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.q_norm = nn.LayerNorm(hd, eps=ln_eps) if qk_norm else None
        self.k_norm = nn.LayerNorm(hd, eps=ln_eps) if qk_norm else None
        self.proj = nn.Linear(dim, dim)
        self.rope_freq = rope_freq

    def forward(self, x, pos=None):
        B, N, C = x.shape
        q, k, v = self.qkv(x).reshape(B, N, 3, self.heads, -1).permute(
            2, 0, 3, 1, 4).unbind(0)                         # [B,H,N,hd]
        if self.q_norm is not None:
            q, k = self.q_norm(q), self.k_norm(k)
        if self.rope_freq is not None and pos is not None:
            q = apply_rope_2d(q, pos, self.rope_freq)
            k = apply_rope_2d(k, pos, self.rope_freq)
        o = fused_sdpa(q, k, v)
        return self.proj(o.transpose(1, 2).reshape(B, N, C))


class LayerScale(nn.Module):
    def __init__(self, dim: int, init: float):
        super().__init__()
        self.gamma = nn.Parameter(torch.full((dim,), float(init)))

    def forward(self, x):
        return x * self.gamma


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, out: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, out)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class Block(nn.Module):
    """vggt/layers/block.py:27-107: pre-LN attention and MLP with optional
    LayerScale, qk-norm and RoPE; exact GELU."""

    def __init__(self, dim: int, heads: int, mlp_ratio: float = 4.0,
                 ls_init: Optional[float] = None, qk_norm: bool = False,
                 rope_freq: Optional[float] = None, ln_eps: float = 1e-5):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=ln_eps)
        self.attn = Attention(dim, heads, qk_norm, rope_freq, ln_eps)
        self.ls1 = LayerScale(dim, ls_init) if ls_init is not None else None
        self.norm2 = nn.LayerNorm(dim, eps=ln_eps)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dim)
        self.ls2 = LayerScale(dim, ls_init) if ls_init is not None else None

    def forward(self, x, pos=None):
        h = self.attn(self.norm1(x), pos)
        x = x + (self.ls1(h) if self.ls1 is not None else h)
        h = self.mlp(self.norm2(x))
        return x + (self.ls2(h) if self.ls2 is not None else h)


# ------------------------------------------------------------ DINOv2 ViT

class PatchEmbed(nn.Module):
    def __init__(self, patch: int, dim: int):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, patch, stride=patch)

    def forward(self, x):
        return self.proj(x).flatten(2).transpose(1, 2)


class DinoViT(nn.Module):
    """DINOv2 ViT-L/14 with register tokens (vision_transformer.py:42-340):
    returns the patch tokens only (x_norm_patchtokens)."""

    def __init__(self, cfg: VGGTConfig):
        super().__init__()
        C, G = cfg.vit_embed_dim, cfg.vit_pos_grid
        self.cfg = cfg
        self.patch_embed = PatchEmbed(cfg.patch_size, C)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, C))
        self.pos_embed = nn.Parameter(torch.zeros(1, 1 + G * G, C))
        self.register_tokens = nn.Parameter(
            torch.zeros(1, cfg.num_register_tokens, C))
        self.mask_token = nn.Parameter(torch.zeros(1, C))    # unused
        self.blocks = nn.ModuleList(
            [Block(C, cfg.vit_num_heads, cfg.mlp_ratio,
                   ls_init=cfg.vit_layerscale_init, ln_eps=1e-6)
             for _ in range(cfg.vit_depth)])
        self.norm = nn.LayerNorm(C, eps=1e-6)

    def interp_pos(self, Hp: int, Wp: int) -> torch.Tensor:
        """vision_transformer.py:183-215 with interpolate_offset 0: torch's
        bicubic to the exact grid; the identity at the pretraining grid."""
        G = self.cfg.vit_pos_grid
        if (Hp, Wp) == (G, G):
            return self.pos_embed
        C = self.pos_embed.shape[-1]
        patch = self.pos_embed[:, 1:].reshape(1, G, G, C).permute(0, 3, 1, 2)
        patch = resize_bicubic_torch(patch, (Hp, Wp))
        return torch.cat([self.pos_embed[:, :1],
                          patch.permute(0, 2, 3, 1).reshape(1, Hp * Wp, C)],
                         1)

    def forward(self, x):
        """x [N, 3, H, W] (already normalised) -> [N, P, C]."""
        N, _, H, W = x.shape
        p = self.cfg.patch_size
        tok = self.patch_embed(x)
        tok = torch.cat([self.cls_token.expand(N, -1, -1), tok], 1)
        tok = tok + self.interp_pos(H // p, W // p)
        tok = torch.cat([tok[:, :1], self.register_tokens.expand(N, -1, -1),
                         tok[:, 1:]], 1)
        for blk in self.blocks:
            tok = blk(tok)
        return self.norm(tok)[:, 1 + self.cfg.num_register_tokens:]


# ------------------------------------------------------------- Aggregator

class Aggregator(nn.Module):
    """Alternating frame/global attention (aggregator.py:187-305).

    Returns ({layer: [B,S,T,2C] frame||global intermediates}, (Hp, Wp),
    the number of special tokens) for the layers the heads read: the
    camera head's ``depth - 1`` and ``cfg.intermediate_layers``."""

    def __init__(self, cfg: VGGTConfig):
        super().__init__()
        C = cfg.embed_dim
        self.cfg = cfg
        self.patch_embed = DinoViT(cfg)
        self.camera_token = nn.Parameter(torch.zeros(1, 2, 1, C))
        self.register_token = nn.Parameter(
            torch.zeros(1, 2, cfg.num_register_tokens, C))

        def aa_block():
            return Block(C, cfg.num_heads, cfg.mlp_ratio,
                         ls_init=cfg.layerscale_init, qk_norm=cfg.qk_norm,
                         rope_freq=cfg.rope_freq)
        self.frame_blocks = nn.ModuleList([aa_block()
                                           for _ in range(cfg.depth)])
        self.global_blocks = nn.ModuleList([aa_block()
                                            for _ in range(cfg.depth)])
        self.register_buffer("mean", torch.tensor(RESNET_MEAN).view(
            1, 1, 3, 1, 1), persistent=False)
        self.register_buffer("std", torch.tensor(RESNET_STD).view(
            1, 1, 3, 1, 1), persistent=False)

    def forward(self, images: torch.Tensor):
        cfg = self.cfg
        B, S, _, H, W = images.shape
        Hp, Wp = H // cfg.patch_size, W // cfg.patch_size
        C = cfg.embed_dim
        x = (images - self.mean) / self.std
        patch_tokens = self.patch_embed(x.reshape(B * S, 3, H, W))

        # index 0 of the special tokens for the first frame (it anchors the
        # world frame), index 1 for the others (aggregator.py:123-133)
        ns = 1 + cfg.num_register_tokens
        sel = torch.clamp(torch.arange(S, device=images.device), max=1)
        special = torch.cat([self.camera_token[0][sel],
                             self.register_token[0][sel]], 1)   # [S,ns,C]
        special = special[None].expand(B, S, ns, C).reshape(B * S, ns, C)
        tokens = torch.cat([special, patch_tokens], 1)
        T = tokens.shape[1]

        # the patch grid (y, x) + 1; special tokens at 0 (aggregator.py:
        # 226-234)
        ys, xs = torch.meshgrid(
            torch.arange(Hp, dtype=torch.float32, device=images.device),
            torch.arange(Wp, dtype=torch.float32, device=images.device),
            indexing="ij")
        grid = torch.stack([ys.reshape(-1), xs.reshape(-1)], -1) + 1.0
        pos_f = torch.cat([grid.new_zeros(ns, 2), grid], 0)      # [T, 2]
        pos_g = pos_f.repeat(S, 1)                               # [S*T, 2]

        needed = set(cfg.intermediate_layers) | {cfg.depth - 1}
        inters: Dict[int, torch.Tensor] = {}
        for i, (fb, gb) in enumerate(zip(self.frame_blocks,
                                         self.global_blocks)):
            tokens = fb(tokens, pos_f)
            frame_out = tokens
            tokens = gb(tokens.reshape(B, S * T, C), pos_g).reshape(
                B * S, T, C)
            if i in needed:
                inters[i] = torch.cat([frame_out, tokens], -1).reshape(
                    B, S, T, 2 * C)
        return inters, (Hp, Wp), ns


# ------------------------------------------------------------ camera head

class CameraHead(nn.Module):
    """Iterative adaLN pose refinement (camera_head.py:19-162): each
    iteration embeds the (detached) previous 9-d encoding, modulates the
    normalised camera tokens, runs the trunk at 2C and adds an MLP delta;
    the fov channels pass a ReLU."""

    def __init__(self, cfg: VGGTConfig):
        super().__init__()
        dim = 2 * cfg.embed_dim
        self.cfg = cfg
        self.trunk = nn.Sequential(*[
            Block(dim, cfg.num_heads, cfg.mlp_ratio,
                  ls_init=cfg.layerscale_init)
            for _ in range(cfg.camera_trunk_depth)])
        self.token_norm = nn.LayerNorm(dim)
        self.trunk_norm = nn.LayerNorm(dim)
        self.empty_pose_tokens = nn.Parameter(torch.zeros(1, 1, 9))
        self.embed_pose = nn.Linear(9, dim)
        self.poseLN_modulation = nn.Sequential(nn.SiLU(),
                                               nn.Linear(dim, 3 * dim))
        self.adaln_norm = nn.LayerNorm(dim, eps=1e-6,
                                       elementwise_affine=False)
        self.pose_branch = Mlp(dim, dim // 2, 9)

    def forward(self, camera_tokens: torch.Tensor) -> torch.Tensor:
        """[B, S, 2C] -> activated pose encodings [B, S, 9]."""
        B, S, _ = camera_tokens.shape
        pose_tokens = self.token_norm(camera_tokens)
        pred = None
        for _ in range(self.cfg.camera_iterations):
            if pred is None:
                inp = self.embed_pose(self.empty_pose_tokens.expand(B, S, 9))
            else:
                inp = self.embed_pose(pred.detach())
            shift, scale, gate = self.poseLN_modulation(inp).chunk(3, -1)
            z = gate * (self.adaln_norm(pose_tokens) * (1 + scale) + shift)
            z = self.trunk(z + pose_tokens)
            delta = self.pose_branch(self.trunk_norm(z))
            pred = delta if pred is None else pred + delta
        # activate_pose: translation and quaternion linear, fov relu
        return torch.cat([pred[..., :7], F.relu(pred[..., 7:])], -1)


# --------------------------------------------------------------- DPT head

def _ac_taps(n_in: int, n_out: int, device):
    """Per output sample its two taps and the second's weight, as the JAX
    package builds them: idx = (i * (n_in - 1)) / (n_out - 1) in float32."""
    if n_out == 1 or n_in == 1:
        idx = torch.zeros(n_out, device=device)
    else:
        idx = (torch.arange(n_out, device=device) * (n_in - 1)).float() \
            / float(n_out - 1)
    lo = torch.clamp(torch.floor(idx).long(), 0, n_in - 1)
    return lo, torch.clamp(lo + 1, max=n_in - 1), idx - lo


def resize_bilinear_ac(x: torch.Tensor, size: Tuple[int, int]
                       ) -> torch.Tensor:
    """Bilinear resize with align_corners=True (the F.interpolate call of
    dpt_head.py) of [..., H, W], rows first, with the JAX package's tap
    positions (F.interpolate's i * ((n_in - 1) / (n_out - 1)) rounds
    differently by a few ulps)."""
    for axis, n_out in ((-2, size[0]), (-1, size[1])):
        n_in = x.shape[axis]
        if n_in == n_out:
            continue
        lo, hi, f = _ac_taps(n_in, n_out, x.device)
        shape = (-1, 1) if axis == -2 else (-1,)
        f = f.to(x.dtype).reshape(shape)
        x = x.index_select(axis, lo) * (1 - f) + x.index_select(axis, hi) * f
    return x


def _uv_pos_embed(Hp: int, Wp: int, dim: int, aspect: float,
                  device=None) -> torch.Tensor:
    """create_uv_grid + position_grid_to_embed (vggt/heads/utils.py) in
    float32 as the JAX package computes it: [dim, Hp, Wp]."""
    diag = math.sqrt(aspect * aspect + 1.0)
    sx, sy = aspect / diag, 1.0 / diag
    xs = torch.linspace(-sx * (Wp - 1) / Wp, sx * (Wp - 1) / Wp, Wp,
                        device=device)
    ys = torch.linspace(-sy * (Hp - 1) / Hp, sy * (Hp - 1) / Hp, Hp,
                        device=device)
    vv, uu = torch.meshgrid(ys, xs, indexing="ij")           # [Hp, Wp]

    def sincos(p, d):
        omega = torch.arange(d // 2, dtype=torch.float32,
                             device=device) / (d / 2.0)
        out = p.reshape(-1)[:, None] * (1.0 / (100.0 ** omega))
        return torch.cat([out.sin(), out.cos()], -1)

    emb = torch.cat([sincos(uu, dim // 2), sincos(vv, dim // 2)], -1)
    return emb.reshape(Hp, Wp, dim).permute(2, 0, 1)


class ResidualConvUnit(nn.Module):
    """dpt_head.py:357-399: x + conv(relu(conv(relu(x))))."""

    def __init__(self, f: int):
        super().__init__()
        self.conv1 = nn.Conv2d(f, f, 3, padding=1)
        self.conv2 = nn.Conv2d(f, f, 3, padding=1)

    def forward(self, x):
        return self.conv2(F.relu(self.conv1(F.relu(x)))) + x


class FeatureFusionBlock(nn.Module):
    """dpt_head.py:402-469: optional lateral residual, refine, align-corners
    bilinear upsample, 1x1 out conv."""

    def __init__(self, f: int, has_residual: bool = True):
        super().__init__()
        self.resConfUnit1 = ResidualConvUnit(f) if has_residual else None
        self.resConfUnit2 = ResidualConvUnit(f)
        self.out_conv = nn.Conv2d(f, f, 1)

    def forward(self, x, res=None, size=None):
        if self.resConfUnit1 is not None:
            x = x + self.resConfUnit1(res)
        x = self.resConfUnit2(x)
        if size is None:
            size = (x.shape[-2] * 2, x.shape[-1] * 2)
        return self.out_conv(resize_bilinear_ac(x, size))


def activate_head(x: torch.Tensor, activation: str, conf_activation: str):
    """head_act.py:61-112 on channels-last input: the last channel is the
    confidence."""
    val, conf = x[..., :-1], x[..., -1]
    if activation == "exp":
        out = torch.exp(val)
    elif activation == "inv_log":
        out = torch.sign(val) * torch.expm1(val.abs())
    elif activation == "norm_exp":
        d = torch.clamp(torch.linalg.vector_norm(val, dim=-1, keepdim=True),
                        min=1e-8)
        out = val / d * torch.expm1(d)
    elif activation == "linear":
        out = val
    elif activation == "relu":
        out = F.relu(val)
    else:
        raise ValueError(f"unknown activation {activation}")
    if conf_activation == "expp1":
        conf_out = 1.0 + torch.exp(conf)
    elif conf_activation == "expp0":
        conf_out = torch.exp(conf)
    elif conf_activation == "sigmoid":
        conf_out = torch.sigmoid(conf)
    else:
        raise ValueError(f"unknown conf_activation {conf_activation}")
    return out, conf_out


class _Scratch(nn.Module):
    def __init__(self, oc, f: int, c1: int, output_dim: Optional[int]):
        super().__init__()
        for i in range(4):
            setattr(self, f"layer{i + 1}_rn",
                    nn.Conv2d(oc[i], f, 3, padding=1, bias=False))
        self.refinenet1 = FeatureFusionBlock(f)
        self.refinenet2 = FeatureFusionBlock(f)
        self.refinenet3 = FeatureFusionBlock(f)
        self.refinenet4 = FeatureFusionBlock(f, has_residual=False)
        self.output_conv1 = nn.Conv2d(f, c1, 3, padding=1)
        self.output_conv2 = None if output_dim is None else nn.Sequential(
            nn.Conv2d(c1, 32, 3, padding=1), nn.ReLU(),
            nn.Conv2d(32, output_dim, 1))


class DPTHead(nn.Module):
    """dpt_head.py:21-304: LayerNorm the 2C tokens of 4 intermediate layers,
    project to the pyramid's channels, add 0.1x uv sincos embeddings, build
    the 4-scale pyramid, refine coarse to fine, then the output convs and
    the activation split (prediction, confidence). ``feature_only`` (the
    track head's extractor) stops after output_conv1 at full width."""

    def __init__(self, cfg: VGGTConfig, output_dim: int = 2,
                 activation: str = "exp", conf_activation: str = "expp1",
                 pos_embed: bool = True, feature_only: bool = False,
                 down_ratio: int = 1, features: Optional[int] = None):
        super().__init__()
        oc = cfg.dpt_out_channels
        f = features if features is not None else cfg.dpt_features
        dim_in = 2 * cfg.embed_dim
        self.cfg = cfg
        self.activation = activation
        self.conf_activation = conf_activation
        self.pos_embed = pos_embed
        self.feature_only = feature_only
        self.down_ratio = down_ratio
        self.norm = nn.LayerNorm(dim_in)
        self.projects = nn.ModuleList([nn.Conv2d(dim_in, o, 1) for o in oc])
        self.resize_layers = nn.ModuleList([
            nn.ConvTranspose2d(oc[0], oc[0], 4, stride=4),
            nn.ConvTranspose2d(oc[1], oc[1], 2, stride=2),
            nn.Identity(),
            nn.Conv2d(oc[3], oc[3], 3, stride=2, padding=1)])
        self.scratch = _Scratch(oc, f, f if feature_only else f // 2,
                                None if feature_only else output_dim)

    def forward(self, inter_list: Sequence[torch.Tensor],
                patch_hw: Tuple[int, int], img_hw: Tuple[int, int]):
        """inter_list: 4 tensors [B, S, P, 2C] (patch tokens only, in
        ``cfg.intermediate_layers``' order) -> (prediction [B,S,H,W,
        output_dim-1], confidence [B,S,H,W]), or the features
        [B,S,f,h,w] when ``feature_only``."""
        S = inter_list[0].shape[1]
        n = FRAMES_CHUNK
        outs = [self._frames([t[:, s:s + n] for t in inter_list], patch_hw,
                             img_hw) for s in range(0, S, n)]
        if self.feature_only:
            return torch.cat(outs, 1)
        return (torch.cat([o[0] for o in outs], 1),
                torch.cat([o[1] for o in outs], 1))

    def _frames(self, inter_list, patch_hw, img_hw):
        Hp, Wp = patch_hw
        H, W = img_hw
        B, S = inter_list[0].shape[:2]
        dev = inter_list[0].device
        pyramid: List[torch.Tensor] = []
        for i, t in enumerate(inter_list):
            x = self.norm(t.reshape(B * S, Hp * Wp, -1))
            x = x.permute(0, 2, 1).reshape(B * S, -1, Hp, Wp)
            x = self.projects[i](x)
            if self.pos_embed:
                x = x + 0.1 * _uv_pos_embed(Hp, Wp, x.shape[1], W / H, dev)
            pyramid.append(self.resize_layers[i](x))
        sc = self.scratch
        l1 = sc.layer1_rn(pyramid[0])
        l2 = sc.layer2_rn(pyramid[1])
        l3 = sc.layer3_rn(pyramid[2])
        l4 = sc.layer4_rn(pyramid[3])
        out = sc.refinenet4(l4, size=l3.shape[2:])
        out = sc.refinenet3(out, l3, size=l2.shape[2:])
        out = sc.refinenet2(out, l2, size=l1.shape[2:])
        out = sc.refinenet1(out, l1)
        out = sc.output_conv1(out)
        p = self.cfg.patch_size
        out = resize_bilinear_ac(out, (Hp * p // self.down_ratio,
                                       Wp * p // self.down_ratio))
        if self.pos_embed:
            out = out + 0.1 * _uv_pos_embed(out.shape[-2], out.shape[-1],
                                            out.shape[1], W / H, dev)
        if self.feature_only:
            return out.reshape(B, S, *out.shape[1:])
        out = sc.output_conv2(out).permute(0, 2, 3, 1)
        pred, conf = activate_head(out, self.activation,
                                   self.conf_activation)
        return (pred.reshape(B, S, *pred.shape[1:]),
                conf.reshape(B, S, *conf.shape[1:]))


# -------------------------------------------------------------- full model

class TrackHead(nn.Module):
    """track_head.py:12-108: the DPT feature extractor (feature-only, down
    ratio 2, no position embedding) and the tracker."""

    def __init__(self, cfg: VGGTConfig):
        super().__init__()
        from .vggt_track import BaseTrackerPredictor, TrackConfig
        tc = TrackConfig(features=cfg.track_features, iters=cfg.track_iters,
                         corr_levels=cfg.track_corr_levels,
                         corr_radius=cfg.track_corr_radius,
                         depth=cfg.track_depth, hidden_size=cfg.track_hidden,
                         num_virtual_tracks=cfg.track_virtual,
                         num_heads=cfg.track_num_heads)
        self.feature_extractor = DPTHead(cfg, feature_only=True,
                                         down_ratio=2, pos_embed=False,
                                         features=tc.features)
        self.tracker = BaseTrackerPredictor(tc)

    def forward(self, inter_list, patch_hw, img_hw, query_points,
                iters: Optional[int] = None):
        fmaps = self.feature_extractor(inter_list, patch_hw, img_hw)
        return self.tracker(query_points, fmaps, iters=iters)


class VGGT(nn.Module):
    """vggt/models/vggt.py:18-97: aggregator + camera head + depth head
    (+ point head, + track head when query points are given). Parameters on
    ``device`` (the GPU unless the caller names another)."""

    def __init__(self, cfg: VGGTConfig = VGGTConfig(),
                 device: torch.device | str | None = None):
        super().__init__()
        self.cfg = cfg
        with torch.device(resolve_device(device)):
            self.aggregator = Aggregator(cfg)
            self.camera_head = CameraHead(cfg)
            self.depth_head = DPTHead(cfg, output_dim=2, activation="exp") \
                if cfg.enable_depth_head else None
            self.point_head = DPTHead(cfg, output_dim=4,
                                      activation="inv_log") \
                if cfg.enable_point_head else None
            self.track_head = TrackHead(cfg) if cfg.enable_track_head \
                else None

    @property
    def device(self) -> torch.device:
        return self.camera_head.empty_pose_tokens.device

    def forward(self, images: torch.Tensor,
                query_points: Optional[torch.Tensor] = None) -> dict:
        """images [B, S, 3, H, W] in [0, 1] -> {pose_enc [B,S,9], depth
        [B,S,H,W], depth_conf, world_points [B,S,H,W,3],
        world_points_conf, (track, vis, conf)}."""
        cfg = self.cfg
        inters, patch_hw, ns = self.aggregator(images)
        out = {"pose_enc": self.camera_head(inters[cfg.depth - 1][:, :, 0])}
        dpt_in = [inters[i][:, :, ns:] for i in cfg.intermediate_layers]
        img_hw = tuple(images.shape[-2:])
        if self.depth_head is not None:
            depth, conf = self.depth_head(dpt_in, patch_hw, img_hw)
            out["depth"] = depth[..., 0]
            out["depth_conf"] = conf
        if self.point_head is not None:
            out["world_points"], out["world_points_conf"] = self.point_head(
                dpt_in, patch_hw, img_hw)
        if self.track_head is not None and query_points is not None:
            # vggt/models/vggt.py:87-93: the last coordinate prediction
            tracks, vis, conf_t = self.track_head(dpt_in, patch_hw, img_hw,
                                                  query_points)
            out["track"], out["vis"], out["conf"] = tracks[-1], vis, conf_t
        return out


def init_vggt_params(model: nn.Module, seed: int = 0) -> nn.Module:
    """Seeded random weights in place, drawn on the model's device with the
    laws of the JAX package's flax initialisers: linear and conv kernels
    N(0, 1/fan_in) (a transposed conv's fan_in as flax counts it on the
    (Cin, Cout, k, k) kernel), biases 0, norms 1 and 0, LayerScales at
    their config's value, the cls/register/camera tokens N(0, 1e-6^2),
    the position table N(0, 0.02^2), the empty pose tokens 0, the track
    head's virtual tracks and query reference tokens N(0, 1) and its
    attention's fused input projection Xavier-uniform."""
    p0 = next(model.parameters())
    gen = torch.Generator(device=p0.device).manual_seed(seed)
    tokens = {"cls_token": 1e-6, "register_tokens": 1e-6,
              "camera_token": 1e-6, "register_token": 1e-6,
              "pos_embed": 0.02, "virual_tracks": 1.0,
              "query_ref_token": 1.0}
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, nn.ConvTranspose2d):
                w = mod.weight
                w.normal_(0.0, 1.0 / math.sqrt(w.shape[2] * w.shape[0]
                                               * w.shape[1]), generator=gen)
            elif isinstance(mod, (nn.Linear, nn.Conv2d)):
                mod.weight.normal_(0.0, 1.0 / math.sqrt(mod.weight[0].numel()),
                                   generator=gen)
            elif isinstance(mod, (nn.LayerNorm, nn.GroupNorm)):
                if mod.weight is not None:
                    mod.weight.fill_(1.0)
                    mod.bias.zero_()
                continue
            if isinstance(mod, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d)):
                if mod.bias is not None:
                    mod.bias.zero_()
                continue
            for name, p in mod.named_parameters(recurse=False):
                if name in tokens:
                    p.normal_(0.0, tokens[name], generator=gen)
                elif name in ("empty_pose_tokens", "mask_token"):
                    p.zero_()
                elif name == "in_proj_weight":
                    bound = math.sqrt(6.0 / (p.shape[0] / 3 * 2
                                             + p.shape[1]))
                    p.uniform_(-bound, bound, generator=gen)
                elif name == "in_proj_bias":
                    p.zero_()
    return model


# ------------------------------------------------ pose encoding utilities

def pose_encoding_to_extri_intri(pose_enc: torch.Tensor, image_hw):
    """9-d encoding [t(3), quat wxyz(4), fov_h, fov_w] (vggt/utils/
    pose_enc.py 'absT_quaR_FoV') -> (w2c extrinsic [..,3,4], K [..,3,3]).
    A ReLU'd fov can be exactly 0 at random init, so it is clamped to 1e-5
    as in the JAX package (a no-op for real checkpoints)."""
    H, W = image_hw
    t = pose_enc[..., :3]
    R = quat_to_rotmat(quat_normalize(pose_enc[..., 3:7]))
    fov_h = torch.clamp(pose_enc[..., 7], min=1e-5)
    fov_w = torch.clamp(pose_enc[..., 8], min=1e-5)
    extri = torch.cat([R, t[..., None]], -1)
    fy = H / (2.0 * torch.tan(fov_h / 2.0))
    fx = W / (2.0 * torch.tan(fov_w / 2.0))
    z, o = torch.zeros_like(fx), torch.ones_like(fx)
    K = torch.stack([
        torch.stack([fx, z, torch.full_like(fx, W / 2)], -1),
        torch.stack([z, fy, torch.full_like(fy, H / 2)], -1),
        torch.stack([z, z, o], -1)], -2)
    return extri, K


def unproject_depth_to_points(depth: torch.Tensor, extri: torch.Tensor,
                              K: torch.Tensor) -> torch.Tensor:
    """[...,H,W] depth + w2c extrinsic + K -> world points [...,H,W,3]
    (vggt/utils/geometry.py unproject_depth_map_to_point_map): R^T (cam -
    t)."""
    H, W = depth.shape[-2:]
    gy, gx = torch.meshgrid(
        torch.arange(H, dtype=torch.float32, device=depth.device),
        torch.arange(W, dtype=torch.float32, device=depth.device),
        indexing="ij")

    def ex(v):
        return v[..., None, None]
    x_cam = (gx - ex(K[..., 0, 2])) / ex(K[..., 0, 0]) * depth
    y_cam = (gy - ex(K[..., 1, 2])) / ex(K[..., 1, 1]) * depth
    cam = torch.stack([x_cam, y_cam, depth], -1)
    R, t = extri[..., :3, :3], extri[..., :3, 3]
    diff = cam - t[..., None, None, :]
    # an explicit f32 contraction (no TF32 on the card)
    return (R.transpose(-1, -2)[..., None, None, :, :]
            * diff[..., None, :]).sum(-1)
