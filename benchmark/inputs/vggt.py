"""The VGGT cell's inputs, made from the seed on the device: the model's
weights in facebook/VGGT-1B's state_dict keys (without the point and
track heads, which the pose estimator does not run) and the clips of
frames.

Each weight is drawn by its own ``randn`` call from one generator, in the
order of ``weight_spec``, and scaled: a linear or convolution weight by
1/sqrt(fan_in) (a transposed convolution's fan-in is its input channels:
its kernel equals its stride, so the patches do not overlap), a bias by
0.02, a LayerNorm scale to 1 + 0.02 n and its shift to 0.02 n, the
qk-LayerNorms' scales to ``qk_norm_gain`` (1 + 0.02 n), the LayerScales
of the aggregator's blocks and the camera trunk to ``layerscale``
(1 + 0.02 n) and the ViT's to ``vit_layerscale_init`` (1 + 0.02 n), and
the learnt tokens (cls, registers, camera, position table, the empty pose
encoding) left N(0, 1). The program copies them into its module one at a
time; the reference draws them again.

A clip is ``num_frames`` frames of one seeded scene as a panning camera
sees it: a random texture wider than a frame with a natural image's 1/f
amplitude spectrum (octaves of bilinear noise from 2 to 128 pixels, each
with an amplitude in proportion to its scale), each frame the window
``pan`` pixels to the right of the one before, with a little per-frame
noise, in [0, 1].
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .room import generator

BIAS_STD = 0.02
NORM_STD = 0.02
OCTAVES = (2, 4, 8, 16, 32, 64, 128)   # pixels per cell of each octave
TEXTURE_STD = 0.2
FRAME_NOISE = 0.02


def weight_spec(cfg: dict) -> list:
    """[(name, shape, kind)]; kind is "weight" (fan_in prod(shape[1:])),
    "tweight" (fan_in shape[0]), "bias", "norm_w", "norm_b", "qk_norm_w",
    "ls", "vit_ls" or "token"."""
    C, C2 = cfg["embed_dim"], 2 * cfg["embed_dim"]
    nreg, p = cfg["num_register_tokens"], cfg["patch_size"]
    grid = cfg["img_size"] // p
    spec = []

    def add(name, shape, kind):
        spec.append((name, tuple(shape), kind))

    def lin(name, n_out, n_in, bias=True):
        add(name + ".weight", (n_out, n_in), "weight")
        if bias:
            add(name + ".bias", (n_out,), "bias")

    def conv(name, n_out, n_in, k, bias=True):
        add(name + ".weight", (n_out, n_in, k, k), "weight")
        if bias:
            add(name + ".bias", (n_out,), "bias")

    def norm(name, n, kind="norm_w"):
        add(name + ".weight", (n,), kind)
        add(name + ".bias", (n,), "norm_b")

    def block(b, dim, ls, qk_norm=False):
        norm(b + "norm1", dim)
        lin(b + "attn.qkv", 3 * dim, dim)
        if qk_norm:
            hd = dim // cfg["num_heads"]
            norm(b + "attn.q_norm", hd, "qk_norm_w")
            norm(b + "attn.k_norm", hd, "qk_norm_w")
        lin(b + "attn.proj", dim, dim)
        add(b + "ls1.gamma", (dim,), ls)
        norm(b + "norm2", dim)
        lin(b + "mlp.fc1", int(dim * cfg["mlp_ratio"]), dim)
        lin(b + "mlp.fc2", dim, int(dim * cfg["mlp_ratio"]))
        add(b + "ls2.gamma", (dim,), ls)

    a = "aggregator."
    add(a + "camera_token", (1, 2, 1, C), "token")
    add(a + "register_token", (1, 2, nreg, C), "token")
    v = a + "patch_embed."
    add(v + "cls_token", (1, 1, C), "token")
    add(v + "pos_embed", (1, 1 + grid * grid, C), "token")
    add(v + "register_tokens", (1, nreg, C), "token")
    add(v + "mask_token", (1, C), "token")
    conv(v + "patch_embed.proj", C, 3, p)
    for i in range(cfg["vit_depth"]):
        block(f"{v}blocks.{i}.", C, "vit_ls")
    norm(v + "norm", C)
    for kind in ("frame_blocks", "global_blocks"):
        for i in range(cfg["depth"]):
            block(f"{a}{kind}.{i}.", C, "ls", qk_norm=True)
    h = "camera_head."
    add(h + "empty_pose_tokens", (1, 1, 9), "token")
    for i in range(cfg["camera_trunk_depth"]):
        block(f"{h}trunk.{i}.", C2, "ls")
    norm(h + "token_norm", C2)
    norm(h + "trunk_norm", C2)
    lin(h + "embed_pose", C2, 9)
    lin(h + "poseLN_modulation.1", 3 * C2, C2)
    lin(h + "pose_branch.fc1", C2 // 2, C2)
    lin(h + "pose_branch.fc2", 9, C2 // 2)
    d = "depth_head."
    oc, f = cfg["dpt_out_channels"], cfg["dpt_features"]
    norm(d + "norm", C2)
    for i, o in enumerate(oc):
        conv(f"{d}projects.{i}", o, C2, 1)
    for i, k in ((0, 4), (1, 2)):
        add(f"{d}resize_layers.{i}.weight", (oc[i], oc[i], k, k), "tweight")
        add(f"{d}resize_layers.{i}.bias", (oc[i],), "bias")
    conv(d + "resize_layers.3", oc[3], oc[3], 3)
    s = d + "scratch."
    for i, o in enumerate(oc):
        conv(f"{s}layer{i + 1}_rn", f, o, 3, bias=False)
    for r in range(1, 5):
        units = (2,) if r == 4 else (1, 2)
        for u in units:
            for c in (1, 2):
                conv(f"{s}refinenet{r}.resConfUnit{u}.conv{c}", f, f, 3)
        conv(f"{s}refinenet{r}.out_conv", f, f, 1)
    conv(s + "output_conv1", f // 2, f, 3)
    conv(s + "output_conv2.0", 32, f // 2, 3)
    conv(s + "output_conv2.2", 2, 32, 1)
    return spec


@torch.no_grad()
def weights(cfg: dict, seed: int, device):
    """Yield (name, f32 tensor) in the order of ``weight_spec``."""
    g = generator(seed, device, 21)
    for name, shape, kind in weight_spec(cfg):
        t = torch.randn(shape, generator=g, device=device)
        if kind == "weight":
            t.mul_(1.0 / math.sqrt(math.prod(shape[1:])))
        elif kind == "tweight":
            t.mul_(1.0 / math.sqrt(shape[0]))
        elif kind in ("bias", "norm_b"):
            t.mul_(BIAS_STD if kind == "bias" else NORM_STD)
        elif kind != "token":
            gain = {"norm_w": 1.0, "qk_norm_w": cfg["qk_norm_gain"],
                    "ls": cfg["layerscale"],
                    "vit_ls": cfg["vit_layerscale_init"]}[kind]
            t.mul_(NORM_STD).add_(1.0).mul_(gain)
        yield name, t


def clip(cfg: dict, traffic: dict, seed: int, index: int, device):
    """Clip ``index`` of the seed: [S, 3, H, W] f32 in [0, 1]."""
    g = generator(seed, device, 22 + index)
    S, H = cfg["num_frames"], cfg["img_size"]
    pan = traffic["pan"]
    W = H + pan * (S - 1)
    tex = torch.zeros((1, 3, H, W), device=device)
    for cell in OCTAVES:
        n = torch.randn((1, 3, H // cell + 2, W // cell + 2), generator=g,
                        device=device)
        tex += cell * F.interpolate(n, scale_factor=cell, mode="bilinear",
                                    align_corners=False)[..., :H, :W]
    tex = (0.5 + TEXTURE_STD * tex / tex.std())[0]
    frames = torch.stack([tex[:, :, i * pan:i * pan + H] for i in range(S)])
    frames += FRAME_NOISE * torch.randn(frames.shape, generator=g,
                                        device=device)
    return frames.clamp_(0.0, 1.0)
