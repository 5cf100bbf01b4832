"""SAM prompt encoder + two-way-transformer mask decoder.

Port of the JAX ``langscenex_tpu/models/sam2/decoder.py`` (the
reference's sam2/modeling/sam/prompt_encoder.py, transformer.py and
mask_decoder.py with the video predictor's settings): random-frequency
point encodings, four point embeddings + not-a-point + no-mask, the
3-conv mask downscaling; the two-way transformer (self attention,
token-to-image and image-to-token cross attention at downsample rate 2);
the decoder's object-score, IoU and four mask tokens, its stride-2
``ConvTranspose2d`` upscaling with the high-resolution skips, exact GELU,
hypernetwork MLPs, a sigmoid IoU head, an MLP object-score head and the
dynamic multimask fallback by stability.

LayerNorms use eps 1e-6 (flax's default, which the JAX package's
decoder keeps; the reference's torch modules use 1e-5). Attention is
``scaled_dot_product_attention``. Tensors are channels-first; the
state_dict uses the sam2_hiera_large.pt keys (``sam_prompt_encoder``,
``sam_mask_decoder``, with ``conv_s0``/``conv_s1`` inside the decoder).
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

LN_EPS = 1e-6


@dataclasses.dataclass(frozen=True)
class DecoderConfig:
    dim: int = 256
    num_heads: int = 8
    mlp_dim: int = 2048
    depth: int = 2
    num_multimask: int = 3     # + 1 single-mask token
    mask_in_chans: int = 16
    iou_head_hidden: int = 256
    stability_delta: float = 0.05
    stability_thresh: float = 0.98


class LayerNorm2d(nn.Module):
    """LayerNorm over the channels of [B,C,H,W] (eps 1e-6)."""

    def __init__(self, c: int, eps: float = LN_EPS):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.eps = eps

    def forward(self, x):
        return F.layer_norm(x.permute(0, 2, 3, 1), x.shape[1:2], self.weight,
                            self.bias, self.eps).permute(0, 3, 1, 2)


class MLP(nn.Module):
    """ReLU between layers, an optional final sigmoid."""

    def __init__(self, din: int, hidden: int, dout: int, n: int,
                 sigmoid_output: bool = False):
        super().__init__()
        dims = [din] + [hidden] * (n - 1)
        outs = [hidden] * (n - 1) + [dout]
        self.layers = nn.ModuleList(nn.Linear(a, b)
                                    for a, b in zip(dims, outs))
        self.sigmoid_output = sigmoid_output

    def forward(self, x):
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = F.relu(x)
        return torch.sigmoid(x) if self.sigmoid_output else x


class AttentionDS(nn.Module):
    """Separate q/k/v projections to dim / downsample_rate; keys and
    values may come in at ``kv_in_dim``."""

    def __init__(self, dim: int, heads: int, downsample_rate: int = 1,
                 kv_in_dim: Optional[int] = None):
        super().__init__()
        d = dim // downsample_rate
        kv = kv_in_dim if kv_in_dim is not None else dim
        self.q_proj = nn.Linear(dim, d)
        self.k_proj = nn.Linear(kv, d)
        self.v_proj = nn.Linear(kv, d)
        self.out_proj = nn.Linear(d, dim)
        self.heads = heads

    def _split(self, x):
        b, n, c = x.shape
        return x.reshape(b, n, self.heads, c // self.heads).transpose(1, 2)

    def _merge(self, o):
        b, h, n, hd = o.shape
        return self.out_proj(o.transpose(1, 2).reshape(b, n, h * hd))

    def forward(self, q, k, v):
        q = self._split(self.q_proj(q))
        k = self._split(self.k_proj(k))
        v = self._split(self.v_proj(v))
        return self._merge(F.scaled_dot_product_attention(q, k, v))


class PromptEncoder(nn.Module):
    """Point coords are absolute pixels in the ``image_size`` frame (the
    +0.5 pixel-centre shift is applied inside)."""

    def __init__(self, cfg: DecoderConfig, image_size: Tuple[int, int],
                 embed_hw: Tuple[int, int]):
        super().__init__()
        C, mc = cfg.dim, cfg.mask_in_chans
        self.pe_layer = nn.Module()
        self.pe_layer.register_buffer(
            "positional_encoding_gaussian_matrix", torch.randn(2, C // 2))
        self.point_embeddings = nn.ModuleList(
            [nn.Embedding(1, C) for _ in range(4)])
        self.not_a_point_embed = nn.Embedding(1, C)
        self.no_mask_embed = nn.Embedding(1, C)
        self.mask_downscaling = nn.Sequential(
            nn.Conv2d(1, mc // 4, 2, 2), LayerNorm2d(mc // 4), nn.GELU(),
            nn.Conv2d(mc // 4, mc, 2, 2), LayerNorm2d(mc), nn.GELU(),
            nn.Conv2d(mc, C, 1))
        self.image_size = tuple(image_size)
        self.embed_hw = tuple(embed_hw)
        self.dim = C

    def _pe(self, coords01):
        g = self.pe_layer.positional_encoding_gaussian_matrix
        x = 2.0 * math.pi * ((2.0 * coords01 - 1.0) @ g)
        return torch.cat([x.sin(), x.cos()], -1)

    def get_dense_pe(self) -> torch.Tensor:
        """[1, C, h, w] encoding of the embedding grid's pixel centres."""
        h, w = self.embed_hw
        dev = self.no_mask_embed.weight.device
        ys = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5) / h
        xs = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) / w
        gx, gy = torch.meshgrid(xs, ys, indexing="xy")
        return self._pe(torch.stack([gx, gy], -1)).permute(2, 0, 1)[None]

    def encode_points(self, coords, labels):
        """coords [B,N,2] absolute (x, y); labels [B,N] (-1 pad, 0 negative,
        1 positive, 2/3 box corners)."""
        H, W = self.image_size
        size = torch.tensor([W, H], dtype=torch.float32,
                            device=coords.device)
        emb = self._pe((coords + 0.5) / size)
        lab = labels[..., None]
        emb = torch.where(lab == -1, self.not_a_point_embed.weight[0], emb)
        for i in range(4):
            emb = torch.where(lab == i,
                              emb + self.point_embeddings[i].weight[0], emb)
        return emb

    def forward(self, coords, labels, mask: Optional[torch.Tensor]):
        sparse = self.encode_points(coords, labels)
        if mask is not None:
            return sparse, self.mask_downscaling(mask)
        h, w = self.embed_hw
        dense = self.no_mask_embed.weight.reshape(1, -1, 1, 1).expand(
            1, self.dim, h, w)
        return sparse, dense


class TwoWayAttentionBlock(nn.Module):
    def __init__(self, dim: int, heads: int, mlp_dim: int,
                 skip_first_layer_pe: bool, mlp_names=("layers",)):
        super().__init__()
        self.self_attn = AttentionDS(dim, heads)
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.cross_attn_token_to_image = AttentionDS(dim, heads, 2)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = TwoWayMLP(dim, mlp_dim, mlp_names)
        self.norm3 = nn.LayerNorm(dim, eps=LN_EPS)
        self.norm4 = nn.LayerNorm(dim, eps=LN_EPS)
        self.cross_attn_image_to_token = AttentionDS(dim, heads, 2)
        self.skip_first_layer_pe = skip_first_layer_pe

    def forward(self, queries, keys, query_pe, key_pe):
        if self.skip_first_layer_pe:
            queries = self.self_attn(queries, queries, queries)
        else:
            q = queries + query_pe
            queries = queries + self.self_attn(q, q, queries)
        queries = self.norm1(queries)
        q, k = queries + query_pe, keys + key_pe
        queries = self.norm2(
            queries + self.cross_attn_token_to_image(q, k, keys))
        queries = self.norm3(queries + self.mlp(queries))
        q, k = queries + query_pe, keys + key_pe
        keys = self.norm4(keys + self.cross_attn_image_to_token(k, q,
                                                                queries))
        return queries, keys


class TwoWayMLP(nn.Module):
    """The block's ReLU MLP; SAM2 names its linears ``layers.0/1``, SAM1
    ``lin1``/``lin2``."""

    def __init__(self, dim: int, hidden: int, names=("layers",)):
        super().__init__()
        self.sam1 = names == ("lin1", "lin2")
        if self.sam1:
            self.lin1 = nn.Linear(dim, hidden)
            self.lin2 = nn.Linear(hidden, dim)
        else:
            self.layers = nn.ModuleList([nn.Linear(dim, hidden),
                                         nn.Linear(hidden, dim)])

    def forward(self, x):
        a, b = (self.lin1, self.lin2) if self.sam1 else self.layers
        return b(F.relu(a(x)))


class TwoWayTransformer(nn.Module):
    def __init__(self, depth: int, dim: int, heads: int, mlp_dim: int,
                 mlp_names=("layers",)):
        super().__init__()
        self.layers = nn.ModuleList(
            [TwoWayAttentionBlock(dim, heads, mlp_dim, i == 0, mlp_names)
             for i in range(depth)])
        self.final_attn_token_to_image = AttentionDS(dim, heads, 2)
        self.norm_final_attn = nn.LayerNorm(dim, eps=LN_EPS)

    def forward(self, image_embedding, image_pe, point_embedding):
        """image_embedding [B,C,h,w], image_pe [1,C,h,w], points [B,N,C]
        -> (queries [B,N,C], keys [B,hw,C])."""
        B = image_embedding.shape[0]
        keys = image_embedding.flatten(2).permute(0, 2, 1)
        kpe = image_pe.flatten(2).permute(0, 2, 1).expand(B, -1, -1)
        queries = point_embedding
        for layer in self.layers:
            queries, keys = layer(queries, keys, point_embedding, kpe)
        q, k = queries + point_embedding, keys + kpe
        queries = self.norm_final_attn(
            queries + self.final_attn_token_to_image(q, k, keys))
        return queries, keys


def upscaling(dim: int) -> nn.Sequential:
    """Two stride-2 transposed convs (dim -> dim/4 -> dim/8) with a
    LayerNorm2d and exact GELUs; indices 0, 1, 3 hold the parameters."""
    return nn.Sequential(
        nn.ConvTranspose2d(dim, dim // 4, 2, 2), LayerNorm2d(dim // 4),
        nn.GELU(), nn.ConvTranspose2d(dim // 4, dim // 8, 2, 2), nn.GELU())


def hyper_masks(mlps, tokens: torch.Tensor, up: torch.Tensor
                ) -> torch.Tensor:
    """Each mask token through its hypernetwork MLP, dotted with the
    upscaled embedding [B,c,H,W] -> [B,M,H,W]."""
    hyper = torch.stack([m(tokens[:, i]) for i, m in enumerate(mlps)], 1)
    b, c, hh, ww = up.shape
    return (hyper @ up.reshape(b, c, hh * ww)).reshape(b, -1, hh, ww)


class MaskDecoder(nn.Module):
    def __init__(self, cfg: DecoderConfig):
        super().__init__()
        C = cfg.dim
        self.cfg = cfg
        self.transformer = TwoWayTransformer(cfg.depth, C, cfg.num_heads,
                                             cfg.mlp_dim)
        self.num_mask_tokens = cfg.num_multimask + 1
        self.iou_token = nn.Embedding(1, C)
        self.mask_tokens = nn.Embedding(self.num_mask_tokens, C)
        self.obj_score_token = nn.Embedding(1, C)
        self.output_upscaling = upscaling(C)
        self.conv_s0 = nn.Conv2d(C, C // 8, 1)
        self.conv_s1 = nn.Conv2d(C, C // 4, 1)
        self.output_hypernetworks_mlps = nn.ModuleList(
            [MLP(C, C, C // 8, 3) for _ in range(self.num_mask_tokens)])
        self.iou_prediction_head = MLP(C, cfg.iou_head_hidden,
                                       self.num_mask_tokens, 3,
                                       sigmoid_output=True)
        self.pred_obj_score_head = MLP(C, C, 1, 3)

    def forward(self, image_embeddings, image_pe, sparse, dense,
                multimask_output: bool,
                high_res_features: Optional[List[torch.Tensor]] = None,
                use_stability_fallback: bool = True):
        """image_embeddings [B,C,h,w]; image_pe [1,C,h,w]; sparse [B,N,C];
        dense broadcastable to [B,C,h,w] -> (masks [B,M,4h,4w], iou [B,M],
        sam_tokens_out [B,M,C], object_score_logits [B,1])."""
        B = sparse.shape[0]
        out_tokens = torch.cat([self.obj_score_token.weight,
                                self.iou_token.weight,
                                self.mask_tokens.weight], 0)
        tokens = torch.cat([out_tokens[None].expand(B, -1, -1), sparse], 1)
        src = image_embeddings + dense
        hs, src = self.transformer(src, image_pe, tokens)
        iou_token_out = hs[:, 1]
        mask_tokens_out = hs[:, 2:2 + self.num_mask_tokens]
        h, w = image_embeddings.shape[-2:]
        src = src.transpose(1, 2).reshape(B, -1, h, w)
        dc1, ln1, act1, dc2, act2 = self.output_upscaling
        up = dc1(src)
        if high_res_features is not None:
            up = up + high_res_features[1]
        up = dc2(act1(ln1(up)))
        if high_res_features is not None:
            up = up + high_res_features[0]
        masks = hyper_masks(self.output_hypernetworks_mlps, mask_tokens_out,
                            act2(up))
        iou = self.iou_prediction_head(iou_token_out)
        obj = self.pred_obj_score_head(hs[:, 0])
        if multimask_output:
            return masks[:, 1:], iou[:, 1:], mask_tokens_out[:, 1:], obj
        if use_stability_fallback:
            out_masks, out_iou = self._stability_select(masks, iou)
        else:
            out_masks, out_iou = masks[:, :1], iou[:, :1]
        return out_masks, out_iou, mask_tokens_out[:, :1], obj

    def _stability_select(self, masks, iou):
        """Fall back from the single-mask token to the best multimask
        output where the single mask's stability is low."""
        d = self.cfg.stability_delta
        flat = masks.flatten(2)
        area_i = (flat > d).sum(-1).float()
        area_u = (flat > -d).sum(-1).float()
        stab = torch.where(area_u > 0, area_i / area_u,
                           torch.ones_like(area_u))[:, 0]
        stable = stab >= self.cfg.stability_thresh
        multi, miou = masks[:, 1:], iou[:, 1:]
        best = miou.argmax(-1)
        bi = torch.arange(masks.shape[0], device=masks.device)
        bm, bio = multi[bi, best][:, None], miou[bi, best][:, None]
        return (torch.where(stable[:, None, None, None], masks[:, :1], bm),
                torch.where(stable[:, None], iou[:, :1], bio))
