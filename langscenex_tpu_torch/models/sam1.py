"""SAM v1 (ViT-H): image encoder, prompt encoder, mask decoder and the
modified 4-level automatic mask generator the reference vendors.

Port of the JAX ``langscenex_tpu/models/sam1.py`` (the reference's
segment-anything-1 image_encoder.py, prompt_encoder.py, mask_decoder.py,
transformer.py, build_sam.py's ViT-H and automatic_mask_generator.py
:137-169 modified to return FOUR granularity levels: default = the three
multimask outputs, then small / medium / large = tokens 0 / 1 / 2):

- the encoder: 16x16 patches, an absolute position embedding, windowed
  blocks (window 14) with decomposed relative-position attention (its
  tables linearly interpolated when the grid differs from their size, as
  the JAX package does it), global attention at blocks 7/15/23/31, a
  2-conv LayerNorm2d neck to 256 channels. The relative-position terms
  enter ``scaled_dot_product_attention`` as its float mask;
- the image goes in as [0, 1] pixels without SAM's mean/std
  normalisation, as in the JAX package, unless the model is built with
  ``normalize_input=True``: then ``preprocess`` does what the
  reference's ``Sam.preprocess`` does to 0-255 pixels (minus
  ``PIXEL_MEAN``, over ``PIXEL_STD``) before the generator zero-pads a
  crop, as the reference pads after normalising;
- the generator: crop boxes (the full image + 2x2 overlapping crops per
  crop layer), each crop resized to the model's frame with
  ``jax.image.resize``'s antialiased bilinear (``ops/interp.resize_linear``)
  and zero-padded, a point grid decoded in batches, stability scores,
  the thresholds, the ``max_proposals`` cap (top by predicted IoU, ties
  in their order) and mask NMS per level. A mask is placed into the
  full image by the integer nearest index of the JAX package; areas for
  the area filter are counted from the low-resolution mask and each low-
  resolution pixel's footprint, so full-resolution masks are only built
  for the proposals that survive the cap.

Masks stay on the model's device; ``segmentation`` entries are [H, W]
bool tensors there. The state_dict uses the sam_vit_h_4b8939.pth keys
(the prompt encoder's ``mask_downscaling`` is there, unused, so that
checkpoint loads strictly); ``convert.sam1_from_numpy`` carries the JAX
model's params across and ``init_sam1_params`` gives seeded random
weights.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.interp import resize_linear
from ..utils.device import resolve_device
from .sam2.amg import nms_levels
from .sam2.decoder import (MLP, LayerNorm2d, TwoWayTransformer, hyper_masks,
                           upscaling)
from .sam2.hiera import window_partition, window_unpartition
from .sam2.model import init_like_flax_


# segment_anything's Sam.pixel_mean / pixel_std, on 0-255 pixels
PIXEL_MEAN = (123.675, 116.28, 103.53)
PIXEL_STD = (58.395, 57.12, 57.375)


@dataclasses.dataclass(frozen=True)
class SAM1Config:
    img_size: int = 1024
    patch_size: int = 16
    embed_dim: int = 1280            # ViT-H
    depth: int = 32
    num_heads: int = 16
    mlp_ratio: float = 4.0
    out_chans: int = 256
    window_size: int = 14
    global_attn_indexes: Sequence[int] = (7, 15, 23, 31)
    decoder_dim: int = 256
    decoder_heads: int = 8
    decoder_mlp: int = 2048
    decoder_depth: int = 2
    num_multimask: int = 3
    mask_in_chans: int = 16

    @property
    def feat_size(self) -> int:
        return self.img_size // self.patch_size


def get_rel_pos(q_size: int, k_size: int, rel_pos: torch.Tensor
                ) -> torch.Tensor:
    """The (2s-1, hd) table gathered into [s, s, hd] by relative offset,
    the table first resized linearly (align_corners=False) when its length
    is not 2 * max(q, k) - 1."""
    max_rel = 2 * max(q_size, k_size) - 1
    if rel_pos.shape[0] != max_rel:
        L = rel_pos.shape[0]
        src = (np.arange(max_rel) + 0.5) * (L / max_rel) - 0.5
        lo = np.clip(np.floor(src).astype(np.int64), 0, L - 1)
        hi = np.minimum(lo + 1, L - 1)
        f = torch.from_numpy(np.clip(src - lo, 0.0, 1.0).astype(np.float32)
                             ).to(rel_pos.device)[:, None]
        rel_pos = (rel_pos[torch.from_numpy(lo).to(rel_pos.device)] * (1 - f)
                   + rel_pos[torch.from_numpy(hi).to(rel_pos.device)] * f)
    coords = (torch.arange(q_size)[:, None] - torch.arange(k_size)[None, :]
              + (k_size - 1))
    return rel_pos[coords.to(rel_pos.device)]


class Attention(nn.Module):
    """Decomposed relative-position attention."""

    def __init__(self, dim: int, heads: int, rel_size: int):
        super().__init__()
        hd = dim // heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.heads = heads
        self.rel_pos_h = nn.Parameter(torch.zeros(2 * rel_size - 1, hd))
        self.rel_pos_w = nn.Parameter(torch.zeros(2 * rel_size - 1, hd))

    def forward(self, x):
        B, H, W, C = x.shape
        nH = self.heads
        qkv = self.qkv(x).reshape(B, H * W, 3, nH, -1).permute(2, 0, 3, 1, 4)
        q, k, v = qkv.reshape(3, B * nH, H * W, -1).unbind(0)
        r_q = q.reshape(B * nH, H, W, -1)
        bias_h = torch.einsum("bhwc,hkc->bhwk", r_q,
                              get_rel_pos(H, H, self.rel_pos_h))
        bias_w = torch.einsum("bhwc,wkc->bhwk", r_q,
                              get_rel_pos(W, W, self.rel_pos_w))
        bias = (bias_h[:, :, :, :, None] + bias_w[:, :, :, None, :]
                ).reshape(B * nH, H * W, H * W)
        o = F.scaled_dot_product_attention(q, k, v, attn_mask=bias)
        o = o.reshape(B, nH, H, W, -1).permute(0, 2, 3, 1, 4).reshape(
            B, H, W, C)
        return self.proj(o)


class MLPBlock(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.lin1 = nn.Linear(dim, hidden)
        self.lin2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.lin2(F.gelu(self.lin1(x)))


class Block(nn.Module):
    def __init__(self, dim: int, heads: int, window_size: int,
                 feat_size: int, mlp_ratio: float = 4.0):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim, heads,
                              window_size if window_size > 0 else feat_size)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = MLPBlock(dim, int(dim * mlp_ratio))
        self.window_size = window_size

    def forward(self, x):
        shortcut = x
        x = self.norm1(x)
        ws = self.window_size
        if ws > 0:
            H, W = x.shape[1:3]
            x, pad_hw = window_partition(x, ws)
        x = self.attn(x)
        if ws > 0:
            x = window_unpartition(x, ws, pad_hw, (H, W))
        x = shortcut + x
        return x + self.mlp(self.norm2(x))


class ImageEncoderViT(nn.Module):
    """[B,3,S,S] -> [B, out_chans, S/16, S/16]."""

    def __init__(self, cfg: SAM1Config):
        super().__init__()
        fs = cfg.feat_size
        self.patch_embed = nn.Module()
        self.patch_embed.proj = nn.Conv2d(3, cfg.embed_dim, cfg.patch_size,
                                          cfg.patch_size)
        self.pos_embed = nn.Parameter(torch.zeros(1, fs, fs, cfg.embed_dim))
        self.blocks = nn.ModuleList([
            Block(cfg.embed_dim, cfg.num_heads,
                  0 if i in cfg.global_attn_indexes else cfg.window_size,
                  fs, cfg.mlp_ratio) for i in range(cfg.depth)])
        self.neck = nn.Sequential(
            nn.Conv2d(cfg.embed_dim, cfg.out_chans, 1, bias=False),
            LayerNorm2d(cfg.out_chans),
            nn.Conv2d(cfg.out_chans, cfg.out_chans, 3, padding=1,
                      bias=False),
            LayerNorm2d(cfg.out_chans))

    def forward(self, x):
        x = self.patch_embed.proj(x).permute(0, 2, 3, 1)
        x = x + self.pos_embed[:, :x.shape[1], :x.shape[2]]
        for blk in self.blocks:
            x = blk(x)
        return self.neck(x.permute(0, 3, 1, 2))


class PromptEncoder(nn.Module):
    """Point prompts only (the generator feeds no mask prompts; the
    ``mask_downscaling`` convs exist for the checkpoint's keys)."""

    def __init__(self, cfg: SAM1Config):
        super().__init__()
        C, mc = cfg.decoder_dim, cfg.mask_in_chans
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
        self.img_size = cfg.img_size
        self.dim = C

    def _pe(self, coords01):
        g = self.pe_layer.positional_encoding_gaussian_matrix
        x = (2.0 * coords01 - 1.0) @ g
        return torch.cat([torch.sin(2 * math.pi * x),
                          torch.cos(2 * math.pi * x)], -1)

    def get_dense_pe(self, hw) -> torch.Tensor:
        """[1, C, h, w]."""
        h, w = hw
        dev = self.no_mask_embed.weight.device
        ys = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5) / h
        xs = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) / w
        gx, gy = torch.meshgrid(xs, ys, indexing="xy")
        return self._pe(torch.stack([gx, gy], -1)).permute(2, 0, 1)[None]

    def forward(self, coords, labels, hw):
        """coords [B,N,2] absolute pixels in the img_size frame."""
        emb = self._pe((coords + 0.5) / self.img_size)
        lab = labels[..., None]
        emb = torch.where(lab == -1, self.not_a_point_embed.weight[0], emb)
        for i in range(4):
            emb = torch.where(lab == i,
                              emb + self.point_embeddings[i].weight[0], emb)
        dense = self.no_mask_embed.weight.reshape(1, -1, 1, 1).expand(
            1, self.dim, hw[0], hw[1])
        return emb, dense


class MaskDecoder(nn.Module):
    """IoU token + 4 mask tokens, the two-way transformer, plain output
    upscaling, hypernetwork MLPs, a linear IoU head."""

    def __init__(self, cfg: SAM1Config):
        super().__init__()
        C = cfg.decoder_dim
        self.transformer = TwoWayTransformer(
            cfg.decoder_depth, C, cfg.decoder_heads, cfg.decoder_mlp,
            mlp_names=("lin1", "lin2"))
        self.num_mask_tokens = cfg.num_multimask + 1
        self.iou_token = nn.Embedding(1, C)
        self.mask_tokens = nn.Embedding(self.num_mask_tokens, C)
        self.output_upscaling = upscaling(C)
        self.output_hypernetworks_mlps = nn.ModuleList(
            [MLP(C, C, C // 8, 3) for _ in range(self.num_mask_tokens)])
        self.iou_prediction_head = MLP(C, 256, self.num_mask_tokens, 3)

    def forward(self, image_embeddings, image_pe, sparse, dense,
                multimask_output: bool):
        B = sparse.shape[0]
        out_tokens = torch.cat([self.iou_token.weight,
                                self.mask_tokens.weight], 0)
        tokens = torch.cat([out_tokens[None].expand(B, -1, -1), sparse], 1)
        hs, src = self.transformer(image_embeddings + dense, image_pe,
                                   tokens)
        h, w = image_embeddings.shape[-2:]
        src = src.transpose(1, 2).reshape(B, -1, h, w)
        masks = hyper_masks(self.output_hypernetworks_mlps,
                            hs[:, 1:1 + self.num_mask_tokens],
                            self.output_upscaling(src))
        iou = self.iou_prediction_head(hs[:, 0])
        if multimask_output:
            return masks[:, 1:], iou[:, 1:]
        return masks[:, :1], iou[:, :1]


class SAM1(nn.Module):
    """Parameters on ``device`` (the GPU unless the caller names
    another)."""

    def __init__(self, cfg: SAM1Config = SAM1Config(),
                 device: torch.device | str | None = None,
                 normalize_input: bool = False):
        super().__init__()
        self.cfg = cfg
        self.normalize_input = normalize_input
        with torch.device(resolve_device(device)):
            self.image_encoder = ImageEncoderViT(cfg)
            self.prompt_encoder = PromptEncoder(cfg)
            self.mask_decoder = MaskDecoder(cfg)

    @property
    def device(self) -> torch.device:
        return self.mask_decoder.iou_token.weight.device

    def preprocess(self, images: torch.Tensor) -> torch.Tensor:
        """[..., 3, H, W] pixels in [0, 1] -> the encoder's input: the same
        pixels, or with ``normalize_input`` (255 x - PIXEL_MEAN) /
        PIXEL_STD per channel (segment_anything's Sam.preprocess)."""
        if not self.normalize_input:
            return images
        mean = torch.tensor(PIXEL_MEAN, device=images.device)[:, None, None]
        std = torch.tensor(PIXEL_STD, device=images.device)[:, None, None]
        return (images * 255.0 - mean) / std

    def encode_image(self, images):
        return self.image_encoder(images)

    def decode_points(self, feats, coords, labels,
                      multimask_output: bool = True):
        """feats [B,C,h,w]; coords [B,N,2] pixels in the model frame."""
        hw = feats.shape[-2:]
        sparse, dense = self.prompt_encoder(coords, labels, hw)
        pe = self.prompt_encoder.get_dense_pe(hw)
        return self.mask_decoder(feats, pe, sparse, dense, multimask_output)


def init_sam1_params(model: SAM1, seed: int = 0) -> SAM1:
    """Seeded random weights for every parameter of ``model``
    (``sam2.model.init_like_flax_``'s laws)."""
    return init_like_flax_(model, seed)


# ------------------------------------------------------------------- AMG

@dataclasses.dataclass(frozen=True)
class SAM1AMGConfig:
    points_per_side: int = 32
    points_per_batch: int = 64
    pred_iou_thresh: float = 0.7
    stability_score_thresh: float = 0.85
    stability_offset: float = 1.0
    box_nms_thresh: float = 0.7
    crop_n_layers: int = 1       # the reference runs with 1 crop layer
    crop_overlap_ratio: float = 512 / 1500
    min_mask_region_area: int = 100
    # the per-level cap before NMS (top-K by predicted_iou), which bounds
    # the [N, H*W] NMS matmul when the thresholds are off
    max_proposals: int = 512


def build_point_grid(n: int) -> np.ndarray:
    step = 1.0 / (2 * n)
    xs = np.linspace(step, 1 - step, n)
    gx, gy = np.meshgrid(xs, xs, indexing='xy')
    return np.stack([gx, gy], -1).reshape(-1, 2).astype(np.float32)


def generate_crop_boxes(im_h, im_w, n_layers, overlap_ratio):
    """The full image + 2^(i+1) x 2^(i+1) overlapping crops per layer,
    XYXY."""
    boxes = [(0, 0, im_w, im_h)]
    short = min(im_h, im_w)
    for layer in range(n_layers):
        n = 2 ** (layer + 1)
        overlap = int(overlap_ratio * short * (2 / n))

        def crop_len(orig, n_crops, ov):
            return int(math.ceil((ov * (n_crops - 1) + orig) / n_crops))
        cw = crop_len(im_w, n, overlap)
        ch = crop_len(im_h, n, overlap)
        x0s = [int((cw - overlap) * i) for i in range(n)]
        y0s = [int((ch - overlap) * i) for i in range(n)]
        for y0 in y0s:
            for x0 in x0s:
                boxes.append((x0, y0, min(x0 + cw, im_w),
                              min(y0 + ch, im_h)))
    return boxes


def stability(logits: torch.Tensor, offset: float) -> torch.Tensor:
    hi = (logits > offset).sum((-2, -1)).float()
    lo = (logits > -offset).sum((-2, -1)).float()
    return hi / torch.clamp(lo, min=1.0)


def _nearest_rows(n_out: int, n_in: int) -> np.ndarray:
    return (np.arange(n_out) * n_in) // n_out


class SAM1AutomaticMaskGenerator:
    """generate(image) -> (default, small, medium, large) lists of
    {segmentation [H,W] bool tensor, predicted_iou, stability_score}.
    Box NMS between proposals is mask NMS, as in the JAX package."""

    def __init__(self, model: SAM1, cfg: SAM1AMGConfig = SAM1AMGConfig()):
        self.model = model.eval()
        self.cfg = cfg
        self.S = model.cfg.img_size

    @torch.no_grad()
    def _process_crop(self, image: torch.Tensor, crop_box):
        """image [3,H,W] float [0,1] on the device -> (low-res logits of
        the crop's valid region [N,3,vh,vw], ious [N,3])."""
        cfg = self.cfg
        x0, y0, x1, y1 = crop_box
        crop = image[:, y0:y1, x0:x1]
        ch, cw = crop.shape[1:]
        scale = self.S / max(ch, cw)
        nh, nw = int(ch * scale + 0.5), int(cw * scale + 0.5)
        padded = torch.zeros(3, self.S, self.S, device=image.device)
        padded[:, :nh, :nw] = self.model.preprocess(
            resize_linear(crop, (nh, nw)))
        feats = self.model.encode_image(padded[None])
        pts = build_point_grid(cfg.points_per_side) * np.array(
            [nw, nh], np.float32)
        masks, ious = [], []
        for s in range(0, len(pts), cfg.points_per_batch):
            batch = torch.from_numpy(pts[s:s + cfg.points_per_batch]).to(
                image.device)[:, None]
            B = batch.shape[0]
            labels = torch.ones(B, 1, dtype=torch.int32,
                                device=image.device)
            m, i = self.model.decode_points(feats.expand(B, -1, -1, -1),
                                            batch, labels, True)
            masks.append(m)
            ious.append(i)
        masks, ious = torch.cat(masks), torch.cat(ious)
        h4 = masks.shape[-2]
        vh = max(int(round(h4 * nh / self.S)), 1)
        vw = max(int(round(h4 * nw / self.S)), 1)
        return masks[..., :vh, :vw], ious

    @torch.no_grad()
    def generate(self, image) -> Tuple[List[Dict], ...]:
        """image [3,H,W] in [0,1] (numpy or tensor)."""
        cfg = self.cfg
        dev = self.model.device
        image = torch.as_tensor(image).to(dev, torch.float32)
        _, H, W = image.shape
        boxes = generate_crop_boxes(H, W, cfg.crop_n_layers,
                                    cfg.crop_overlap_ratio)
        per_level: List[List[Dict]] = [[] for _ in range(4)]
        for box in boxes:
            masks, ious = self._process_crop(image, box)
            st = stability(masks, cfg.stability_offset).cpu().numpy()
            iou = ious.cpu().numpy()
            x0, y0, x1, y1 = box
            seg = masks > 0
            ys = _nearest_rows(y1 - y0, seg.shape[-2])
            xs = _nearest_rows(x1 - x0, seg.shape[-1])
            # each low-res pixel's footprint in the full image
            cy = torch.from_numpy(np.bincount(ys, minlength=seg.shape[-2])
                                  ).to(dev)
            cx = torch.from_numpy(np.bincount(xs, minlength=seg.shape[-1])
                                  ).to(dev)
            area = torch.einsum("nthw,h,w->nt", seg.float(), cy.float(),
                                cx.float()).round().long().cpu().numpy()
            place = (torch.from_numpy(ys).to(dev), torch.from_numpy(xs).to(
                dev), box)
            for n in range(seg.shape[0]):
                for tok in range(3):
                    i, s = float(iou[n, tok]), float(st[n, tok])
                    if i <= cfg.pred_iou_thresh or \
                            s <= cfg.stability_score_thresh:
                        continue
                    if area[n, tok] < cfg.min_mask_region_area:
                        continue
                    entry = {"low_res": (seg, n, tok, place),
                             "predicted_iou": i, "stability_score": s}
                    per_level[0].append(entry)
                    per_level[1 + tok].append(entry)
        for lvl in range(4):
            entries = per_level[lvl]
            if cfg.max_proposals and len(entries) > cfg.max_proposals:
                per_level[lvl] = sorted(
                    entries, key=lambda e: -e["predicted_iou"]
                )[:cfg.max_proposals]
        for entries in per_level:
            for e in entries:
                if "segmentation" not in e:
                    e["segmentation"] = _mask_to_image(*e["low_res"],
                                                       (H, W))
        out = nms_levels(per_level, cfg.box_nms_thresh)
        return tuple([{k: v for k, v in e.items() if k != "low_res"}
                      for e in lvl] for lvl in out)


def _mask_to_image(seg, n, tok, place, hw) -> torch.Tensor:
    """A crop's low-res mask placed into the full image (the integer
    nearest index (i * n_in) // n_out)."""
    ys, xs, (x0, y0, x1, y1) = place
    out = torch.zeros(hw, dtype=torch.bool, device=seg.device)
    out[y0:y1, x0:x1] = seg[n, tok].index_select(0, ys).index_select(1, xs)
    return out
