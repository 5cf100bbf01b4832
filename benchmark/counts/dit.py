"""Operations and bytes of the CogVideoX DiT, counted from a configuration's
shapes (a multiply-add is two operations)."""
from __future__ import annotations


def tokens(cfg: dict) -> tuple:
    """(text tokens, video tokens) of one sequence."""
    p = cfg["patch_size"]
    f = (cfg["num_frames"] - 1) // cfg["vae_scale_factor_temporal"] + 1
    h = cfg["height"] // cfg["vae_scale_factor_spatial"] // p
    w = cfg["width"] // cfg["vae_scale_factor_spatial"] // p
    return cfg["text_len"], f * h * w


def attention_flops(batch: int, heads: int, seq: int, head_dim: int) -> float:
    """S = Q K^T and O = P V over a full [seq, seq] score matrix."""
    return 4.0 * batch * heads * seq * seq * head_dim


def forward_flops(cfg: dict, batch: int) -> dict:
    """One DiT call on ``batch`` sequences: the projections and the MLP of
    every block, the joint attention, the adaLN-Zero modulations, the
    patch and text embeddings, the timestep MLP and the output head."""
    hid = cfg["num_heads"] * cfg["head_dim"]
    L, V = tokens(cfg)
    T = L + V
    te = cfg["time_embed_dim"]
    p = cfg["patch_size"]
    per_block = (2.0 * T * hid * hid * 4          # q, k, v, out
                 + 2.0 * T * hid * 4 * hid * 2    # MLP up and down
                 + 2.0 * te * 6 * hid * 2)        # two LayerNormZero linears
    blocks = batch * cfg["num_layers"] * per_block
    attn = cfg["num_layers"] * attention_flops(batch, cfg["num_heads"], T,
                                               cfg["head_dim"])
    embed = batch * (2.0 * V * cfg["in_channels"] * p * p * hid
                     + 2.0 * L * cfg["text_embed_dim"] * hid
                     + 2.0 * (hid * te + te * te))
    head = batch * (2.0 * te * 2 * hid
                    + 2.0 * V * hid * p * p * cfg["out_channels"])
    return dict(matmul=blocks + embed + head, attention=attn,
                total=blocks + embed + head + attn)


def step_flops(cfg: dict) -> float:
    """One guided denoise step: the DiT on [uncond; cond], batch 2."""
    return forward_flops(cfg, 2)["total"]


def ln_modulate_bytes(batch: int, seq: int, hidden: int,
                      elem: int = 2) -> int:
    """K8 reads x and writes y once, and reads gamma, beta and four
    [batch, hidden] modulations."""
    return 2 * batch * seq * hidden * elem + (2 + 4 * batch) * hidden * elem
