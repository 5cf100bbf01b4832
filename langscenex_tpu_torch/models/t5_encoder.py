"""T5 v1.1 text encoder (the pipeline's T5-XXL prompt encoder).

Port of the JAX ``langscenex_tpu/models/t5_encoder.py``: RMS layer norms,
a relative-position bucket bias computed in block 0 and shared by every
block, unscaled attention, a gated tanh-GELU feed-forward, no biases.
The bias and the padding mask (-1e9 on padded keys, added in f32) go into
``scaled_dot_product_attention`` as its float mask, with ``scale=1.0``.

The state_dict uses Hugging Face ``T5EncoderModel``'s keys
(``shared.weight`` = ``encoder.embed_tokens.weight``,
``encoder.block.{i}.layer.{0,1}...``, ``encoder.final_layer_norm.weight``),
so an HF state dict loads with ``load_state_dict``;
``convert.t5_encoder_from_numpy`` carries the JAX model's params across.

The bucket formula is the JAX package's, which is not HF's: ``+ 1e-6``
inside the f32 log, then a truncation to int32. It is evaluated on the
CPU for every sequence length, so each offset's bucket is the same on
every device.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class T5Config:
    # defaults = google/t5-v1_1-xxl (the CogVideoX text encoder)
    vocab_size: int = 32128
    d_model: int = 4096
    d_kv: int = 64
    d_ff: int = 10240
    num_layers: int = 24
    num_heads: int = 64
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    layer_norm_epsilon: float = 1e-6
    dtype: torch.dtype = torch.float32


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        y = xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + self.eps)
        return (self.weight * y.to(x.dtype)).to(x.dtype)


def relative_position_bucket(rel: torch.Tensor, num_buckets: int,
                             max_distance: int) -> torch.Tensor:
    """Bidirectional T5 bucket of integer offsets ``rel`` (memory - query):
    half the buckets for the sign, half of the rest for exact small
    offsets, the others log-spaced up to ``max_distance``. int32."""
    num_buckets //= 2
    ret = (rel > 0).to(torch.int32) * num_buckets
    n = rel.abs().to(torch.int32)
    max_exact = num_buckets // 2
    frac = torch.log(n.to(torch.float32) / max_exact + 1e-6) / float(
        np.float32(np.log(max_distance / max_exact)))
    val_large = max_exact + (frac * (num_buckets - max_exact)).to(
        torch.int32)
    val_large = torch.clamp(val_large, max=num_buckets - 1)
    return ret + torch.where(n < max_exact, n, val_large)


class T5Attention(nn.Module):
    def __init__(self, cfg: T5Config, has_bias_table: bool):
        super().__init__()
        inner = cfg.num_heads * cfg.d_kv
        self.cfg = cfg
        self.q = nn.Linear(cfg.d_model, inner, bias=False)
        self.k = nn.Linear(cfg.d_model, inner, bias=False)
        self.v = nn.Linear(cfg.d_model, inner, bias=False)
        self.o = nn.Linear(inner, cfg.d_model, bias=False)
        if has_bias_table:
            self.relative_attention_bias = nn.Embedding(
                cfg.relative_attention_num_buckets, cfg.num_heads)

    def position_bias(self, T: int, device) -> torch.Tensor:
        """[1, heads, T, T] f32 from the layer-0 table."""
        pos = torch.arange(T)
        buckets = relative_position_bucket(
            pos[None, :] - pos[:, None],
            self.cfg.relative_attention_num_buckets,
            self.cfg.relative_attention_max_distance).to(device)
        table = self.relative_attention_bias.weight.float()
        return table[buckets.long()].permute(2, 0, 1)[None]

    def forward(self, x, bias):
        B, T, _ = x.shape
        H, hd = self.cfg.num_heads, self.cfg.d_kv

        def split(y):
            return y.reshape(B, T, H, hd).transpose(1, 2)
        q, k, v = split(self.q(x)), split(self.k(x)), split(self.v(x))
        o = F.scaled_dot_product_attention(q, k, v, attn_mask=bias.to(
            q.dtype), scale=1.0)
        return self.o(o.transpose(1, 2).reshape(B, T, H * hd))


class T5LayerSelfAttention(nn.Module):
    def __init__(self, cfg: T5Config, has_bias_table: bool):
        super().__init__()
        self.SelfAttention = T5Attention(cfg, has_bias_table)
        self.layer_norm = RMSNorm(cfg.d_model, cfg.layer_norm_epsilon)


class T5DenseGatedActDense(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        self.wi_0 = nn.Linear(cfg.d_model, cfg.d_ff, bias=False)
        self.wi_1 = nn.Linear(cfg.d_model, cfg.d_ff, bias=False)
        self.wo = nn.Linear(cfg.d_ff, cfg.d_model, bias=False)

    def forward(self, h):
        return self.wo(F.gelu(self.wi_0(h), approximate="tanh")
                       * self.wi_1(h))


class T5LayerFF(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        self.DenseReluDense = T5DenseGatedActDense(cfg)
        self.layer_norm = RMSNorm(cfg.d_model, cfg.layer_norm_epsilon)


class T5Block(nn.Module):
    def __init__(self, cfg: T5Config, has_bias_table: bool):
        super().__init__()
        self.layer = nn.ModuleList([T5LayerSelfAttention(cfg, has_bias_table),
                                    T5LayerFF(cfg)])

    def forward(self, x, bias):
        sa, ff = self.layer
        x = x + sa.SelfAttention(sa.layer_norm(x), bias)
        return x + ff.DenseReluDense(ff.layer_norm(x))


class T5Stack(nn.Module):
    def __init__(self, cfg: T5Config, embed_tokens: nn.Embedding):
        super().__init__()
        self.embed_tokens = embed_tokens
        self.block = nn.ModuleList([T5Block(cfg, i == 0)
                                    for i in range(cfg.num_layers)])
        self.final_layer_norm = RMSNorm(cfg.d_model, cfg.layer_norm_epsilon)


class T5Encoder(nn.Module):
    """input_ids [B,T] int, attention_mask [B,T] (1 = keep) ->
    last_hidden_state [B,T,d_model] in ``cfg.dtype``. Parameters on
    ``device`` (the GPU unless the caller names another)."""

    def __init__(self, cfg: T5Config = T5Config(),
                 device: torch.device | str | None = None):
        super().__init__()
        self.cfg = cfg
        with torch.device(resolve_device(device)):
            self.shared = nn.Embedding(cfg.vocab_size, cfg.d_model)
            self.encoder = T5Stack(cfg, self.shared)

    def forward(self, input_ids: torch.Tensor,
                attention_mask: torch.Tensor | None = None) -> torch.Tensor:
        cfg = self.cfg
        dev = self.shared.weight.device
        x = self.shared(input_ids.to(dev).long()).to(cfg.dtype)
        T = x.shape[1]
        bias = self.encoder.block[0].layer[0].SelfAttention.position_bias(
            T, dev)
        if attention_mask is not None:
            keep = attention_mask.to(dev)[:, None, None, :] > 0
            bias = bias + torch.where(keep, 0.0, -1e9).to(torch.float32)
        for blk in self.encoder.block:
            x = blk(x, bias)
        return self.encoder.final_layer_norm(x)


def init_t5_(model: T5Encoder, seed: int = 0) -> T5Encoder:
    """Seeded random weights in place, with the JAX initialisers' laws:
    the embedding and the bias table N(0, 1), every projection
    N(0, 1/fan_in), every norm 1. Drawn on the model's device."""
    dev = model.shared.weight.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("layer_norm.weight"):
                p.fill_(1.0)
            elif p.ndim == 2 and ("shared" in name
                                  or "relative_attention_bias" in name):
                p.normal_(0.0, 1.0, generator=gen)
            else:
                p.normal_(0.0, 1.0 / math.sqrt(p.shape[1]), generator=gen)
    return model
