"""CLIP's vision tower with dense per-pixel embeddings, and its text tower,
port of the JAX ``models/clip_dense.py``.

It stands in for the reference's OpenSeg TF SavedModel
(field_construction/preprocessor.py:22-90), which emits 768-d per-pixel
CLIP-aligned embeddings: CLIP ViT-L/14 with MaskCLIP's value readout
(arXiv 2112.01071 §3.2) emits per-patch embeddings in the same joint
space at the same 768-d width. The last block runs twice: with softmax
attention for the CLS pooling, and with the identity as its attention
map (each token attends to itself, out_i = OutProj(V(x_i))) for the dense
tokens; both then take the MLP, the post-LN and the visual projection.
The position table is resized to the patch grid as ``jax.image.resize``'s
bilinear does (``ops/interp.resize_linear``), so frames run at their own
aspect.

``ClipDenseExtractor`` is the drop-in for ``models/openseg.
OpenSegExtractor``: the long side to at most 672, CLIP's mean/std, the
dense map nearest-resized to the segment map's size (as
``ops/interp.resize_nearest`` does ``jax.image.resize``'s 'nearest').
``CLIPTextEncoder`` embeds open-vocabulary queries into the same space
(causal attention, the final LN, pooling at the first EOS token, the text
projection); it takes token ids, so it runs without ``transformers``.

The modules' state_dicts have Hugging Face's keys
(``CLIPVisionModelWithProjection``, ``CLIPTextModelWithProjection``,
including the historical ``pre_layrnorm``); checkpoints load with
``torch.load(weights_only=True)``. ``convert.clip_vision_from_numpy`` and
``clip_text_from_numpy`` carry the JAX params across.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.interp import resize_linear, resize_nearest
from ..utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    hidden_size: int = 1024
    intermediate_size: int = 4096
    num_layers: int = 24
    num_heads: int = 16
    patch_size: int = 14
    image_size: int = 224          # the grid of the position table
    projection_dim: int = 768
    layer_norm_eps: float = 1e-5

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_layers: int = 12
    num_heads: int = 12
    max_positions: int = 77
    projection_dim: int = 768
    eos_token_id: int = 49407
    layer_norm_eps: float = 1e-5


def quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


class CLIPAttention(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.q_proj = nn.Linear(dim, dim)
        self.k_proj = nn.Linear(dim, dim)
        self.v_proj = nn.Linear(dim, dim)
        self.out_proj = nn.Linear(dim, dim)

    def forward(self, x, identity_attn: bool = False, causal: bool = False):
        v = self.v_proj(x)
        if not identity_attn:      # MaskCLIP's readout leaves q, k unused
            B, T, C = x.shape

            def heads(t):
                return t.reshape(B, T, self.heads, -1).transpose(1, 2)
            v = F.scaled_dot_product_attention(
                heads(self.q_proj(x)), heads(self.k_proj(x)), heads(v),
                is_causal=causal).transpose(1, 2).reshape(B, T, C)
        return self.out_proj(v)


class CLIPMLP(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(quick_gelu(self.fc1(x)))


class CLIPEncoderLayer(nn.Module):
    def __init__(self, dim: int, hidden: int, heads: int, eps: float):
        super().__init__()
        self.self_attn = CLIPAttention(dim, heads)
        self.layer_norm1 = nn.LayerNorm(dim, eps=eps)
        self.mlp = CLIPMLP(dim, hidden)
        self.layer_norm2 = nn.LayerNorm(dim, eps=eps)

    def forward(self, x, identity_attn: bool = False, causal: bool = False):
        x = x + self.self_attn(self.layer_norm1(x), identity_attn, causal)
        return x + self.mlp(self.layer_norm2(x))


class _Encoder(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.layers = nn.ModuleList([
            CLIPEncoderLayer(c.hidden_size, c.intermediate_size, c.num_heads,
                             c.layer_norm_eps) for _ in range(c.num_layers)])


class _VisionEmbeddings(nn.Module):
    def __init__(self, c: CLIPVisionConfig):
        super().__init__()
        g = c.image_size // c.patch_size
        self.class_embedding = nn.Parameter(torch.zeros(c.hidden_size))
        self.patch_embedding = nn.Conv2d(3, c.hidden_size, c.patch_size,
                                         stride=c.patch_size, bias=False)
        self.position_embedding = nn.Embedding(1 + g * g, c.hidden_size)


class _VisionModel(nn.Module):
    def __init__(self, c: CLIPVisionConfig):
        super().__init__()
        self.embeddings = _VisionEmbeddings(c)
        self.pre_layrnorm = nn.LayerNorm(c.hidden_size, eps=c.layer_norm_eps)
        self.encoder = _Encoder(c)
        self.post_layernorm = nn.LayerNorm(c.hidden_size,
                                           eps=c.layer_norm_eps)


def resize_pos_embed(pos: torch.Tensor, src_grid: int, gh: int,
                     gw: int) -> torch.Tensor:
    """[1 + src^2, D] -> [1 + gh*gw, D], the grid resized as
    ``jax.image.resize``'s bilinear (antialiased when it shrinks)."""
    if gh == src_grid and gw == src_grid:
        return pos
    D = pos.shape[-1]
    grid = pos[1:].reshape(src_grid, src_grid, D).permute(2, 0, 1)
    grid = resize_linear(grid, (gh, gw)).permute(1, 2, 0)
    return torch.cat([pos[:1], grid.reshape(gh * gw, D)], 0)


class CLIPVisionDense(nn.Module):
    """pixels [B, 3, H, W] (CLIP-normalised; H, W multiples of the patch)
    -> (pooled [B, proj], dense [B, proj, gh, gw]). Parameters on
    ``device`` (the GPU unless the caller names another)."""

    def __init__(self, cfg: CLIPVisionConfig = CLIPVisionConfig(),
                 device: torch.device | str | None = None):
        super().__init__()
        self.cfg = cfg
        with torch.device(resolve_device(device)):
            self.vision_model = _VisionModel(cfg)
            self.visual_projection = nn.Linear(
                cfg.hidden_size, cfg.projection_dim, bias=False)

    @property
    def device(self) -> torch.device:
        return self.visual_projection.weight.device

    def forward(self, pixels: torch.Tensor):
        c = self.cfg
        vm = self.vision_model
        B, _, H, W = pixels.shape
        gh, gw = H // c.patch_size, W // c.patch_size
        tokens = vm.embeddings.patch_embedding(pixels)
        tokens = tokens.flatten(2).transpose(1, 2)
        x = torch.cat([vm.embeddings.class_embedding.expand(B, 1, -1),
                       tokens], 1)
        x = x + resize_pos_embed(vm.embeddings.position_embedding.weight,
                                 c.image_size // c.patch_size, gh, gw)
        x = vm.pre_layrnorm(x)
        layers = vm.encoder.layers
        for layer in layers[:-1]:
            x = layer(x)
        # the last block twice: softmax attention for the CLS pooling, the
        # identity map for the dense readout
        x_cls = layers[-1](x)
        x_dense = layers[-1](x, identity_attn=True)
        proj = self.visual_projection
        pooled = proj(vm.post_layernorm(x_cls[:, 0]))
        dense = proj(vm.post_layernorm(x_dense[:, 1:]))
        return pooled, dense.transpose(1, 2).reshape(B, -1, gh, gw)


class _TextEmbeddings(nn.Module):
    def __init__(self, c: CLIPTextConfig):
        super().__init__()
        self.token_embedding = nn.Embedding(c.vocab_size, c.hidden_size)
        self.position_embedding = nn.Embedding(c.max_positions,
                                               c.hidden_size)


class _TextModel(nn.Module):
    def __init__(self, c: CLIPTextConfig):
        super().__init__()
        self.embeddings = _TextEmbeddings(c)
        self.encoder = _Encoder(c)
        self.final_layer_norm = nn.LayerNorm(c.hidden_size,
                                             eps=c.layer_norm_eps)


class CLIPTextEncoder(nn.Module):
    """input_ids [B, T] -> pooled [B, projection_dim] (HF
    CLIPTextModelWithProjection's text_embeds, pooled at the first EOS
    token as the JAX package does)."""

    def __init__(self, cfg: CLIPTextConfig = CLIPTextConfig(),
                 device: torch.device | str | None = None):
        super().__init__()
        self.cfg = cfg
        with torch.device(resolve_device(device)):
            self.text_model = _TextModel(cfg)
            self.text_projection = nn.Linear(
                cfg.hidden_size, cfg.projection_dim, bias=False)

    @property
    def device(self) -> torch.device:
        return self.text_projection.weight.device

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        tm = self.text_model
        T = input_ids.shape[1]
        x = tm.embeddings.token_embedding(input_ids) \
            + tm.embeddings.position_embedding.weight[:T]
        for layer in tm.encoder.layers:
            x = layer(x, causal=True)
        x = tm.final_layer_norm(x)
        eos = torch.argmax((input_ids == self.cfg.eos_token_id).int(), 1)
        pooled = x[torch.arange(x.shape[0], device=x.device), eos]
        return self.text_projection(pooled)


def init_clip_params(model: nn.Module, seed: int = 0) -> nn.Module:
    """Seeded random weights in place with the laws of the JAX package's
    flax initialisers: linear and conv kernels N(0, 1/fan_in), biases 0,
    LayerNorms 1 and 0, token embeddings N(0, 1), the class and position
    embeddings N(0, 0.02^2)."""
    p0 = next(model.parameters())
    gen = torch.Generator(device=p0.device).manual_seed(seed)
    with torch.no_grad():
        for name, m in model.named_modules():
            if isinstance(m, (nn.Linear, nn.Conv2d)):
                m.weight.normal_(0.0, 1.0 / math.sqrt(m.weight[0].numel()),
                                 generator=gen)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
            elif isinstance(m, nn.Embedding):
                std = 1.0 if name.endswith("token_embedding") else 0.02
                m.weight.normal_(0.0, std, generator=gen)
            elif isinstance(m, _VisionEmbeddings):
                m.class_embedding.normal_(0.0, 0.02, generator=gen)
    return model


CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


class ClipDenseExtractor:
    """image -> [C, H, W] per-pixel embeddings, the patch grid
    nearest-resized to the segment map (the reference's nearest resize of
    OpenSeg's output, preprocessor.py:71-77). ``model`` is a
    ``CLIPVisionDense`` (or its state_dict in HF's keys)."""

    def __init__(self, model, cfg: CLIPVisionConfig = CLIPVisionConfig(),
                 max_side: int = 672,
                 device: torch.device | str | None = None):
        if isinstance(model, dict):
            sd = model
            model = CLIPVisionDense(cfg, device=device)
            model.load_state_dict(sd, strict=True)
        self.model = model.eval()
        self.cfg = model.cfg
        self.max_side = max_side

    @classmethod
    def from_torch_checkpoint(cls, path: str, cfg=CLIPVisionConfig(),
                              device: torch.device | str | None = None,
                              **kw):
        sd = torch.load(path, map_location="cpu", weights_only=True)
        return cls(sd, cfg, device=device, **kw)

    def pixels(self, image) -> torch.Tensor:
        """[H,W,3] uint8 or float in [0, 1], or PNG bytes -> CLIP's input
        [1, 3, th, tw] on the model's device."""
        if isinstance(image, (bytes, bytearray)):
            from ..utils.png import decode_png, to_rgb
            image = to_rgb(decode_png(bytes(image)))
        image = np.asarray(image)
        if image.dtype == np.uint8:
            image = image.astype(np.float32) / 255.0
        ps = self.cfg.patch_size
        H, W = image.shape[:2]
        scale = min(self.max_side / max(H, W), 1.0)
        th = max(int(round(H * scale / ps)), 1) * ps
        tw = max(int(round(W * scale / ps)), 1) * ps
        x = torch.from_numpy(np.ascontiguousarray(
            image.transpose(2, 0, 1), np.float32)).to(self.model.device)
        x = resize_linear(x, (th, tw))
        mean = torch.tensor(CLIP_MEAN, device=x.device)[:, None, None]
        std = torch.tensor(CLIP_STD, device=x.device)[:, None, None]
        return ((x - mean) / std)[None]

    @torch.no_grad()
    def extract(self, image, hw) -> torch.Tensor:
        """image: [H,W,3] uint8 / float in [0, 1], or the image file's
        bytes (the ``extract_scene_features`` contract); hw: the output's
        (H, W). The [C, H, W] map stays on the model's device, where
        ``models/openseg.mask_pool_features`` pools it."""
        dense = self.model(self.pixels(image))[1][0]          # [C, gh, gw]
        return resize_nearest(dense, tuple(hw))
