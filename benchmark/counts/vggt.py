"""Operations of one VGGT forward, counted from a configuration's shapes (a
multiply-add is two operations): the DINOv2 ViT, the aggregator's frame
and global blocks, the camera head and the DPT depth head. Norms,
activations, RoPE and the softmax's exponentials are not counted."""
from __future__ import annotations

from benchmark.counts.dit import attention_flops


def tokens(cfg: dict) -> tuple:
    """(frames S, tokens a frame T: a camera token, the registers and the
    patches)."""
    grid = cfg["img_size"] // cfg["patch_size"]
    return cfg["num_frames"], 1 + cfg["num_register_tokens"] + grid * grid


def block_flops(n_tokens: int, dim: int, mlp_ratio: float) -> float:
    """The projections (qkv, out) and the MLP of one block over
    ``n_tokens`` tokens."""
    return 2.0 * n_tokens * dim * (4 * dim + 2 * int(dim * mlp_ratio))


def conv_flops(n_out_pixels: int, c_in: int, c_out: int, k: int) -> float:
    return 2.0 * n_out_pixels * c_in * c_out * k * k


def dpt_flops(cfg: dict) -> float:
    """The depth head over every frame: the projections of the four
    layers, the resize layers, the pyramid's convolutions, the fusion
    blocks and the output convolutions."""
    S, _ = tokens(cfg)
    g = cfg["img_size"] // cfg["patch_size"]
    c2, f = 2 * cfg["embed_dim"], cfg["dpt_features"]
    oc = cfg["dpt_out_channels"]
    sizes = (4 * g, 2 * g, g, (g + 1) // 2)            # the pyramid's sides
    n = conv_flops(g * g, c2, sum(oc), 1)              # projects
    n += 2.0 * g * g * oc[0] * oc[0] * 16              # transposed 4x4, s4
    n += 2.0 * g * g * oc[1] * oc[1] * 4               # transposed 2x2, s2
    n += conv_flops(sizes[3] ** 2, oc[3], oc[3], 3)    # 3x3, s2
    n += sum(conv_flops(s * s, o, f, 3) for s, o in zip(sizes, oc))
    for i, s in enumerate(sizes):                      # refinenet1..4
        units = 1 if i == 3 else 2
        n += units * 2 * conv_flops(s * s, f, f, 3)
        up = 2 * s if i == 0 else sizes[i - 1]
        n += conv_flops(up * up, f, f, 1)              # out_conv
    side = 8 * g                                       # refinenet1's output
    n += conv_flops(side * side, f, f // 2, 3)         # output_conv1
    full = g * cfg["patch_size"]
    n += conv_flops(full * full, f // 2, 32, 3) + conv_flops(full * full, 32,
                                                             2, 1)
    return S * n


def camera_flops(cfg: dict) -> float:
    """The camera head's iterations: the pose embedding, the modulation,
    the trunk (its attention over the frames' camera tokens) and the pose
    branch."""
    S, _ = tokens(cfg)
    c2 = 2 * cfg["embed_dim"]
    per_iter = (2.0 * S * (9 * c2 + c2 * 3 * c2 + c2 * c2 // 2 + c2 // 2 * 9)
                + cfg["camera_trunk_depth"] * (
                    block_flops(S, c2, cfg["mlp_ratio"])
                    + attention_flops(1, cfg["num_heads"], S,
                                      c2 // cfg["num_heads"])))
    return cfg["camera_iterations"] * per_iter


def forward_flops(cfg: dict) -> dict:
    """One forward over one clip: {vit, frame_attn, global_attn, blocks
    (the 2·depth + vit_depth blocks' projections and MLPs), patch_embed,
    camera, dpt, aggregator (the ViT and the aggregator), total}."""
    S, T = tokens(cfg)
    C, H = cfg["embed_dim"], cfg["num_heads"]
    hd = C // H
    blocks = (2 * cfg["depth"] + cfg["vit_depth"]) * block_flops(
        S * T, C, cfg["mlp_ratio"])
    frame = attention_flops(S, H, T, hd)
    glob = attention_flops(1, H, S * T, hd)
    patches = S * (T - 1 - cfg["num_register_tokens"])
    patch_embed = 2.0 * patches * 3 * cfg["patch_size"] ** 2 * C
    out = dict(blocks=blocks,
               frame_attn=(cfg["depth"] + cfg["vit_depth"]) * frame,
               global_attn=cfg["depth"] * glob, patch_embed=patch_embed,
               camera=camera_flops(cfg), dpt=dpt_flops(cfg))
    out["aggregator"] = (blocks + out["frame_attn"] + out["global_attn"]
                         + patch_embed)
    out["total"] = out["aggregator"] + out["camera"] + out["dpt"]
    return out
