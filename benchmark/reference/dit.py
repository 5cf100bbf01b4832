"""Plain reference of one TriMap denoise step in float32 PyTorch: the
CogVideoX DiT (diffusers' CogVideoXTransformer3DModel: per-frame 2x2
patch embedding, text tokens prepended, joint full attention with
qk-LayerNorm and 3D RoPE on the video tokens, adaLN-Zero with separate
video and text modulations, GELU (tanh) MLP, AdaLayerNorm head and
unpatchify), classifier-free guidance over [uncond; cond] and the
CogVideoX DDIM update (v-prediction, SNR shift 3, zero-SNR rescale,
trailing spacing).

Weights are read layer by layer from the seeded bf16 buffer and widened
to f32; TF32 is off. ``precision="fp8"`` is the control: every matrix
product (the linears, the patch convolution, attention's q, k and v)
takes its operands rounded to float8 e4m3 with one scale per tensor. It
imports nothing of the program.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

FP8_MAX = 448.0


def fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under one scale for the tensor."""
    s = x.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
    return (x / s).to(torch.float8_e4m3fn).float() * s


class Ops:
    def __init__(self, precision: str, params: dict):
        if precision not in ("f32", "fp8"):
            raise ValueError(precision)
        self.q = fp8 if precision == "fp8" else (lambda x: x)
        self.p = params

    def w(self, name):
        return self.p[name].float()

    def linear(self, x, name):
        return F.linear(self.q(x), self.q(self.w(name + ".weight")),
                        self.w(name + ".bias"))

    def norm(self, x, name, eps):
        return F.layer_norm(x, x.shape[-1:], self.w(name + ".weight"),
                            self.w(name + ".bias"), eps)


def timestep_features(t: torch.Tensor, dim: int) -> torch.Tensor:
    half = dim // 2
    f = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=t.device) / half)
    a = t[:, None].float() * f[None]
    return torch.cat([torch.cos(a), torch.sin(a)], -1)


def rope_tables(cfg: dict, frames: int, hp: int, wp: int, dev):
    """cos, sin [frames*hp*wp, head_dim/2]: a quarter of the head for time,
    three eighths each for height and width."""
    D = cfg["head_dim"]
    dims = (D // 4, D * 3 // 8, D * 3 // 8)

    def axis(n, d):
        inv = 1.0 / (10000.0 ** (torch.arange(0, d, 2, dtype=torch.float32,
                                              device=dev) / d))
        return torch.outer(torch.arange(n, dtype=torch.float32, device=dev),
                           inv)
    ft, fh, fw = axis(frames, dims[0]), axis(hp, dims[1]), axis(wp, dims[2])
    g = torch.cat([ft[:, None, None].expand(frames, hp, wp, -1),
                   fh[None, :, None].expand(frames, hp, wp, -1),
                   fw[None, None, :].expand(frames, hp, wp, -1)], -1)
    g = g.reshape(frames * hp * wp, -1)
    return torch.cos(g), torch.sin(g)


def rotate(x: torch.Tensor, cos, sin) -> torch.Tensor:
    """Interleaved-pair rotation of x [B, T, H, D] by [T, D/2] tables."""
    x1, x2 = x[..., 0::2], x[..., 1::2]
    c, s = cos[None, :, None], sin[None, :, None]
    return torch.stack([x1 * c - x2 * s, x2 * c + x1 * s], -1).reshape(
        x.shape)


@torch.no_grad()
def forward(params: dict, cfg: dict, latents: torch.Tensor,
            text: torch.Tensor, t: torch.Tensor,
            precision: str = "f32") -> torch.Tensor:
    """latents [B, F, 2C, H, W], text [B, L, D_text], t [B] ->
    the model's output [B, F, C_out, H, W], in f32."""
    op = Ops(precision, params)
    B, Fr, C, H, W = latents.shape
    p, nh, hd = cfg["patch_size"], cfg["num_heads"], cfg["head_dim"]
    h = nh * hd
    L = text.shape[1]
    x = F.conv2d(op.q(latents.reshape(B * Fr, C, H, W)),
                 op.q(op.w("patch_embed.proj.weight")),
                 op.w("patch_embed.proj.bias"), stride=p)
    x = x.flatten(2).transpose(1, 2).reshape(B, -1, h)
    x = torch.cat([op.linear(text, "patch_embed.text_proj"), x], 1)
    temb = op.linear(F.silu(op.linear(timestep_features(t, h),
                                      "time_embedding.linear_1")),
                     "time_embedding.linear_2")
    cos, sin = rope_tables(cfg, Fr, H // p, W // p, latents.device)
    st = F.silu(temb)
    for i in range(cfg["num_layers"]):
        b = f"transformer_blocks.{i}."
        x = _block(op, b, x, st, cos, sin, L, nh, hd)
    video = op.norm(x, "norm_final", 1e-5)[:, L:]
    shift, scale = op.linear(st, "norm_out.linear").chunk(2, -1)
    video = op.norm(video, "norm_out.norm", 1e-5) * (1 + scale[:, None]) \
        + shift[:, None]
    video = op.linear(video, "proj_out")
    co = cfg["out_channels"]
    video = video.reshape(B, Fr, H // p, W // p, co, p, p)
    return video.permute(0, 1, 4, 2, 5, 3, 6).reshape(B, Fr, co, H, W)


def _modulated(op, name, x, st, L):
    """LayerNormZero: the normalised stream with the text rows' and the
    video rows' shift and scale, and the two gates."""
    sh, sc, g, tsh, tsc, tg = op.linear(st, name + ".linear").chunk(6, -1)
    n = op.norm(x, name + ".norm", 1e-5)
    n = torch.cat([n[:, :L] * (1 + tsc[:, None]) + tsh[:, None],
                   n[:, L:] * (1 + sc[:, None]) + sh[:, None]], 1)
    return n, g[:, None], tg[:, None]


def _block(op, b, x, st, cos, sin, L, nh, hd):
    B, T, _ = x.shape

    def gated(y, g, tg):
        return torch.cat([tg * y[:, :L], g * y[:, L:]], 1)
    n, g, tg = _modulated(op, b + "norm1", x, st, L)
    q = op.norm(op.linear(n, b + "attn1.to_q").view(B, T, nh, hd),
                b + "attn1.norm_q", 1e-6)
    k = op.norm(op.linear(n, b + "attn1.to_k").view(B, T, nh, hd),
                b + "attn1.norm_k", 1e-6)
    v = op.linear(n, b + "attn1.to_v").view(B, T, nh, hd)
    q = torch.cat([q[:, :L], rotate(q[:, L:], cos, sin)], 1)
    k = torch.cat([k[:, :L], rotate(k[:, L:], cos, sin)], 1)
    del n
    o = F.scaled_dot_product_attention(
        op.q(q).transpose(1, 2), op.q(k).transpose(1, 2),
        op.q(v).transpose(1, 2))
    del q, k, v
    o = op.linear(o.transpose(1, 2).reshape(B, T, nh * hd),
                  b + "attn1.to_out.0")
    x = x + gated(o, g, tg)
    n, g, tg = _modulated(op, b + "norm2", x, st, L)
    y = F.gelu(op.linear(n, b + "ff.net.0.proj"), approximate="tanh")
    return x + gated(op.linear(y, b + "ff.net.2"), g, tg)


def alphas_cumprod(n_train: int = 1000, beta_start: float = 0.00085,
                   beta_end: float = 0.012, shift: float = 3.0) -> np.ndarray:
    """scaled_linear betas, the CogVideoX SNR shift and the zero-SNR
    terminal rescale, as f32."""
    betas = np.linspace(beta_start ** 0.5, beta_end ** 0.5, n_train) ** 2
    ac = np.cumprod(1.0 - betas)
    ac = ac / (shift - (shift - 1.0) * ac)
    sq = np.sqrt(ac)
    sq0, sqT = sq[0].copy(), sq[-1].copy()
    sq = (sq - sqT) * sq0 / (sq0 - sqT)
    return (sq ** 2).astype(np.float32)


def timesteps(n_steps: int, n_train: int = 1000) -> list:
    """Trailing spacing."""
    return [int(t) for t in np.arange(n_train, 0, -n_train / n_steps)
            .round().astype(np.int64) - 1]


def ddim_step(v: torch.Tensor, x: torch.Tensor, t: int, t_prev: int,
              ac: np.ndarray) -> torch.Tensor:
    """Deterministic DDIM from t to t_prev with a v-prediction."""
    a = float(ac[t])
    ap = float(ac[t_prev]) if t_prev >= 0 else 1.0
    x0 = math.sqrt(a) * x - math.sqrt(1.0 - a) * v
    eps = math.sqrt(a) * v + math.sqrt(1.0 - a) * x
    return math.sqrt(ap) * x0 + math.sqrt(1.0 - ap) * eps


@torch.no_grad()
def step(params: dict, cfg: dict, req: dict, k: int, x: torch.Tensor,
         precision: str = "f32") -> dict:
    """Step ``k`` of the request's schedule from latents ``x``: the guided
    DiT call's output on [uncond; cond], the latents after the DDIM update
    and ``x`` itself."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ts = timesteps(cfg["num_inference_steps"])
    t_prev = ts[k + 1] if k + 1 < len(ts) else -1
    model_in = torch.cat([x, req["image"]], 2).expand(2, -1, -1, -1, -1)
    text = torch.cat([req["uncond"], req["cond"]], 0)
    tt = torch.full((2,), ts[k], dtype=torch.int64, device=x.device)
    out = forward(params, cfg, model_in, text, tt, precision)
    un, co = out.chunk(2, 0)
    v = un + cfg["guidance_scale"] * (co - un)
    return dict(out=out, latents=ddim_step(v, x, ts[k], t_prev,
                                           alphas_cumprod()), x=x)
