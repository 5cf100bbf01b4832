"""The TriMap cell's inputs, made from the seed on the device: the DiT's
weights in the type they are served in, the noise and keyframe latents
of one request, and the prompt embeddings.

The weights are one bf16 buffer drawn by a single ``randn`` call, cut
into every parameter in the order of ``weight_spec`` (the diffusers
CogVideoXTransformer3DModel keys) and scaled in place: a linear or
convolution weight by 1/sqrt(fan_in), a bias by 0.02, a LayerNorm scale
to 1 + 0.02 n and its shift by 0.02; the qk-LayerNorms' scales to
``qk_norm_gain`` (1 + 0.02 n), which sets how sharply attention picks
its keys and so how far the prompt's 226 tokens move the output. The
driver loads these views into the program's module; the reference draws
the same buffer again.
"""
from __future__ import annotations

import math

import torch

from .room import generator

BIAS_STD = 0.02
NORM_STD = 0.02


def weight_spec(cfg: dict) -> list:
    """[(name, shape, kind)] with kind one of "weight" (fan_in =
    prod(shape[1:])), "bias", "norm_w", "qk_norm_w", "norm_b"."""
    h = cfg["num_heads"] * cfg["head_dim"]
    te, p = cfg["time_embed_dim"], cfg["patch_size"]
    spec = []

    def lin(name, n_out, n_in):
        spec.append((name + ".weight", (n_out, n_in), "weight"))
        spec.append((name + ".bias", (n_out,), "bias"))

    def norm(name, n, kind="norm_w"):
        spec.append((name + ".weight", (n,), kind))
        spec.append((name + ".bias", (n,), "norm_b"))
    spec.append(("patch_embed.proj.weight", (h, cfg["in_channels"], p, p),
                 "weight"))
    spec.append(("patch_embed.proj.bias", (h,), "bias"))
    lin("patch_embed.text_proj", h, cfg["text_embed_dim"])
    lin("time_embedding.linear_1", te, h)
    lin("time_embedding.linear_2", te, te)
    for i in range(cfg["num_layers"]):
        b = f"transformer_blocks.{i}."
        lin(b + "norm1.linear", 6 * h, te)
        norm(b + "norm1.norm", h)
        for k in ("to_q", "to_k", "to_v"):
            lin(b + "attn1." + k, h, h)
        norm(b + "attn1.norm_q", cfg["head_dim"], "qk_norm_w")
        norm(b + "attn1.norm_k", cfg["head_dim"], "qk_norm_w")
        lin(b + "attn1.to_out.0", h, h)
        lin(b + "norm2.linear", 6 * h, te)
        norm(b + "norm2.norm", h)
        lin(b + "ff.net.0.proj", 4 * h, h)
        lin(b + "ff.net.2", h, 4 * h)
    norm("norm_final", h)
    lin("norm_out.linear", 2 * h, te)
    norm("norm_out.norm", h)
    lin("proj_out", p * p * cfg["out_channels"], h)
    return spec


@torch.no_grad()
def weights(cfg: dict, seed: int, device, dtype=torch.bfloat16) -> dict:
    """{name: tensor} views of one seeded buffer in ``dtype``."""
    spec = weight_spec(cfg)
    total = sum(math.prod(s) for _, s, _ in spec)
    flat = torch.randn((total,), generator=generator(seed, device, 11),
                       dtype=dtype, device=device)
    out, off = {}, 0
    for name, shape, kind in spec:
        n = math.prod(shape)
        t = flat[off:off + n].view(shape)
        off += n
        if kind == "weight":
            t.mul_(1.0 / math.sqrt(math.prod(shape[1:])))
        elif kind == "norm_w":
            t.mul_(NORM_STD).add_(1.0)
        elif kind == "qk_norm_w":
            t.mul_(NORM_STD).add_(1.0).mul_(cfg["qk_norm_gain"])
        else:
            t.mul_(BIAS_STD if kind == "bias" else NORM_STD)
        out[name] = t
    return out


def latent_shape(cfg: dict) -> tuple:
    f = (cfg["num_frames"] - 1) // cfg["vae_scale_factor_temporal"] + 1
    return (1, f, cfg["latent_channels"],
            cfg["height"] // cfg["vae_scale_factor_spatial"],
            cfg["width"] // cfg["vae_scale_factor_spatial"])


def request(cfg: dict, seed: int, device) -> dict:
    """One request's f32 inputs: the noise latents, the image latents
    (the two encoded keyframes at the first and last latent frames,
    zeros between) and the cond and uncond prompt embeddings."""
    g = generator(seed, device, 12)
    shape = latent_shape(cfg)
    noise = torch.randn(shape, generator=g, device=device)
    key = cfg["keyframe_latent_std"]
    first = key * torch.randn((1, 1) + shape[2:], generator=g, device=device)
    last = key * torch.randn((1, 1) + shape[2:], generator=g, device=device)
    mid = torch.zeros((1, shape[1] - 2) + shape[2:], device=device)
    image = torch.cat([first, mid, last], dim=1)
    L, D = cfg["text_len"], cfg["text_embed_dim"]
    cond = torch.randn((1, L, D), generator=g, device=device)
    uncond = torch.randn((1, L, D), generator=g, device=device)
    return dict(noise=noise, image=image, cond=cond, uncond=uncond)
