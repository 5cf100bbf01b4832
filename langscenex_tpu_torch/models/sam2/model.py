"""SAM2 assembled model + video predictor.

Port of the JAX ``langscenex_tpu/models/sam2/model.py`` (the reference's
sam2_base.py: track_step, _forward_sam_heads, _use_mask_as_output,
_prepare_memory_conditioned_features, _encode_new_memory, with the
sam2_hiera_l.yaml + build_sam.py video-predictor settings): the no-memory
embedding added on conditioning frames, object pointers in the memory
(past only, each split into C / mem_dim tokens), object scores with the
fixed no-object pointer, the 20 / -10 sigmoid scaling of masks for the
memory encoder, multimask tracking with the chosen token's pointer, and
mask prompts used as the output without SAM.

The resizes are ``jax.image.resize``'s (``ops/interp.resize_linear``):
the low-resolution masks upsampled bilinearly to the image size, and a
prompt mask downsampled 4x with the antialiased triangle filter.

``SAM2VideoPredictor`` keeps the JAX package's host API: ``init_state``,
``add_new_mask``, ``propagate_in_video`` (a generator over frames, each
object group by its prompt-frame signature decoded as one batch, its
memory assembled from the conditioning frames, the previous
``num_maskmem - 1`` frames and up to ``max_obj_ptrs`` object pointers).
Masks, memories and pointers stay on the model's device; the yielded
masks are tensors there.

The state_dict uses the sam2_hiera_large.pt keys, so that checkpoint's
``model`` dict loads with ``load_state_dict``; ``convert.sam2_from_numpy``
carries the JAX model's params across and ``init_sam2_params`` gives
seeded random weights.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, NamedTuple, Tuple

import torch
import torch.nn as nn

from ...ops.interp import resize_linear
from ...utils.device import resolve_device
from .decoder import (MLP, DecoderConfig, LayerNorm2d, MaskDecoder,
                      PromptEncoder)
from .hiera import HieraConfig, ImageEncoder, sine_pos_embed
from .memory import MemoryAttention, MemoryConfig, MemoryEncoder

NO_OBJ_SCORE = -1024.0


IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


@dataclasses.dataclass(frozen=True)
class SAM2Config:
    hiera: HieraConfig = HieraConfig()
    decoder: DecoderConfig = DecoderConfig()
    memory: MemoryConfig = MemoryConfig()
    image_size: int = 1024
    backbone_stride: int = 16
    sigmoid_scale_for_mem_enc: float = 20.0
    sigmoid_bias_for_mem_enc: float = -10.0
    binarize_mask_from_pts_for_mem_enc: bool = True
    non_overlap_masks_for_mem_enc: bool = False

    @property
    def embed_hw(self) -> Tuple[int, int]:
        s = self.image_size // self.backbone_stride
        return (s, s)


class SAM2(nn.Module):
    """Parameters on ``device`` (the GPU unless the caller names
    another)."""

    def __init__(self, cfg: SAM2Config = SAM2Config(),
                 device: torch.device | str | None = None,
                 normalize_input: bool = False):
        super().__init__()
        self.cfg = cfg
        self.normalize_input = normalize_input
        C, mem = cfg.decoder.dim, cfg.memory.mem_dim
        with torch.device(resolve_device(device)):
            self.image_encoder = ImageEncoder(cfg.hiera)
            self.sam_prompt_encoder = PromptEncoder(
                cfg.decoder, (cfg.image_size, cfg.image_size), cfg.embed_hw)
            self.sam_mask_decoder = MaskDecoder(cfg.decoder)
            self.memory_attention = MemoryAttention(cfg.memory)
            self.memory_encoder = MemoryEncoder(cfg.memory)
            self.maskmem_tpos_enc = nn.Parameter(
                torch.zeros(cfg.memory.num_maskmem, 1, 1, mem))
            self.no_mem_embed = nn.Parameter(torch.zeros(1, 1, C))
            self.no_mem_pos_enc = nn.Parameter(torch.zeros(1, 1, C))
            self.no_obj_ptr = nn.Parameter(torch.zeros(1, C))
            self.obj_ptr_proj = MLP(C, C, C, 3)
            self.mask_downsample = nn.Conv2d(1, 1, 4, 4)

    @property
    def device(self) -> torch.device:
        return self.no_obj_ptr.device

    def forward_image(self, images: torch.Tensor) -> Dict:
        """images [B,3,S,S] -> {"backbone_fpn": [B,C_i,h_i,w_i] high
        resolution first (levels 0 and 1 through conv_s0/conv_s1),
        "vision_pos_enc": [C,h_i,w_i], "vision_features": the last
        level}. Images are [0, 1] pixels; with ``normalize_input`` they are
        first normalised with the ImageNet mean and std, as the
        reference's init_state and image predictor do (the JAX package
        feeds them as they are, the default)."""
        if self.normalize_input:
            mean = torch.tensor(IMAGENET_MEAN, device=images.device)
            std = torch.tensor(IMAGENET_STD, device=images.device)
            images = (images - mean[:, None, None]) / std[:, None, None]
        fpn, pos = self.image_encoder(images)
        fpn = list(fpn)
        fpn[0] = self.sam_mask_decoder.conv_s0(fpn[0])
        fpn[1] = self.sam_mask_decoder.conv_s1(fpn[1])
        return {"backbone_fpn": fpn, "vision_pos_enc": pos,
                "vision_features": fpn[-1]}

    def condition_features(self, feats, curr_pos, memory, memory_pos,
                           num_obj_ptr_tokens: int = 0):
        """feats [B,C,h,w] + memory [B,M,mem_dim] -> conditioned feats."""
        B, C, h, w = feats.shape
        x = feats.flatten(2).transpose(1, 2)
        p = curr_pos.reshape(C, h * w).T[None].expand(B, -1, -1)
        out = self.memory_attention(x, memory, p, memory_pos,
                                    num_obj_ptr_tokens)
        return out.transpose(1, 2).reshape(B, C, h, w)

    def add_no_mem_embed(self, feats):
        """Conditioning frames skip memory attention
        (directly_add_no_mem_embed)."""
        return feats + self.no_mem_embed.reshape(1, -1, 1, 1)

    def _obj_ptr(self, token, is_obj):
        lam = is_obj.float()
        return lam * self.obj_ptr_proj(token) + (1 - lam) * self.no_obj_ptr

    def forward_sam_heads(self, backbone_features, point_coords=None,
                          point_labels=None, mask_inputs=None,
                          high_res_features=None,
                          multimask_output: bool = False):
        """backbone_features [B,C,h,w]; mask_inputs [B,1,4h,4w] low-res
        logits or None -> (low_res_multimasks, high_res_multimasks, ious,
        low_res_masks, high_res_masks, obj_ptr, object_score_logits)."""
        B = backbone_features.shape[0]
        S = self.cfg.image_size
        dev = backbone_features.device
        if point_coords is None:
            point_coords = torch.zeros(B, 1, 2, device=dev)
            point_labels = -torch.ones(B, 1, dtype=torch.int32, device=dev)
        sparse, dense = self.sam_prompt_encoder(point_coords, point_labels,
                                                mask_inputs)
        low_multi, ious, sam_tokens, obj = self.sam_mask_decoder(
            backbone_features, self.sam_prompt_encoder.get_dense_pe(),
            sparse, dense, multimask_output, high_res_features)
        is_obj = obj > 0
        low_multi = torch.where(is_obj[:, :, None, None], low_multi,
                                torch.full_like(low_multi, NO_OBJ_SCORE))
        high_multi = resize_linear(low_multi, (S, S))
        token = sam_tokens[:, 0]
        if multimask_output:
            best = ious.argmax(-1)
            bi = torch.arange(B, device=dev)
            low, high = low_multi[bi, best][:, None], high_multi[bi,
                                                                 best][:, None]
            if sam_tokens.shape[1] > 1:
                token = sam_tokens[bi, best]
        else:
            low, high = low_multi, high_multi
        return (low_multi, high_multi, ious, low, high,
                self._obj_ptr(token, is_obj), obj)

    def use_mask_as_output(self, backbone_features, high_res_features,
                           mask_inputs):
        """Prompted frames emit the input mask; the SAM heads still run on
        the 4x-downsampled mask for the object pointer."""
        mask_f = mask_inputs.float()
        high = mask_f * 20.0 - 10.0
        B, _, H, W = high.shape
        low = resize_linear(high, (H // 4, W // 4), antialias=True)
        ious = torch.ones(B, 1, device=high.device)
        obj_ptr = self.forward_sam_heads(
            backbone_features, mask_inputs=self.mask_downsample(mask_f),
            high_res_features=high_res_features)[5]
        lam = (mask_f.flatten(1) > 0).any(1)[:, None].float()
        obj_logits = 20.0 * lam - 10.0
        obj_ptr = lam * obj_ptr + (1 - lam) * self.no_obj_ptr
        return low, high, ious, low, high, obj_ptr, obj_logits

    def encode_new_memory(self, pix_feat, high_res_masks,
                          is_mask_from_pts: bool = False):
        """pix_feat [B,C,h,w] (unconditioned); high_res_masks [B,1,16h,16w]
        logits -> [B,mem_dim,h,w]."""
        cfg = self.cfg
        if cfg.binarize_mask_from_pts_for_mem_enc and is_mask_from_pts:
            m = (high_res_masks > 0).float()
        else:
            m = torch.sigmoid(high_res_masks)
        m = m * cfg.sigmoid_scale_for_mem_enc + cfg.sigmoid_bias_for_mem_enc
        return self.memory_encoder(pix_feat, m)


def init_like_flax_(model: nn.Module, seed: int = 0) -> nn.Module:
    """Seeded random weights in place, drawn on the model's device with
    the laws of the JAX package's flax initialisers: linear and conv
    kernels N(0, 1/fan_in) (flax's lecun_normal scale; a transposed conv's
    fan_in as flax counts it on the (Cin, Cout, k, k) kernel), biases 0,
    norms 1 and 0, tokens, embeddings and the prompt encoder's Gaussian
    matrix N(0, 1), SAM2's memory glue N(0, 0.02^2), position embeddings
    and relative-position tables 0, ConvNeXt layer scales 1e-6."""
    p0 = next(model.parameters())
    gen = torch.Generator(device=p0.device).manual_seed(seed)

    def normal(t, std):
        t.normal_(0.0, std, generator=gen)

    glue = ("no_mem_embed", "no_mem_pos_enc", "maskmem_tpos_enc",
            "no_obj_ptr")
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, nn.ConvTranspose2d):
                w = mod.weight
                normal(w, 1.0 / math.sqrt(w.shape[2] * w.shape[0]
                                          * w.shape[1]))
            elif isinstance(mod, (nn.Linear, nn.Conv2d, nn.Conv3d)):
                w = mod.weight
                normal(w, 1.0 / math.sqrt(w[0].numel()))
            elif isinstance(mod, (nn.LayerNorm, LayerNorm2d)):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
                continue
            elif isinstance(mod, nn.Embedding):
                normal(mod.weight, 1.0)
                continue
            if isinstance(mod, (nn.Linear, nn.Conv2d, nn.Conv3d,
                                nn.ConvTranspose2d)):
                if mod.bias is not None:
                    mod.bias.zero_()
                continue
            for name, p in mod.named_parameters(recurse=False):
                if name in glue:
                    normal(p, 0.02)
                elif name == "gamma":
                    p.fill_(1e-6)
                elif name.startswith(("pos_embed", "rel_pos_")):
                    p.zero_()
            for name, b in mod.named_buffers(recurse=False):
                if name == "positional_encoding_gaussian_matrix":
                    normal(b, 1.0)
    return model


def init_sam2_params(model: SAM2, seed: int = 0) -> SAM2:
    """Seeded random weights for every parameter of ``model`` (random
    smoke runs; real weights come from a checkpoint)."""
    return init_like_flax_(model, seed)


class FrameOutput(NamedTuple):
    """Per-(object group, frame) tracking output."""
    maskmem: torch.Tensor     # [B, h*w, mem_dim]
    obj_ptr: torch.Tensor     # [B, C]
    is_cond: bool


class SAM2VideoPredictor:
    """Streaming multi-object video propagation over ``model``.

      init_state(frames)                      -> state dict
      add_new_mask(state, frame_idx, obj_id, mask)
      propagate_in_video(state, start_frame, reverse) -> yields
          (frame_idx, obj_ids, low-res mask logits [B,1,4h,4w])
    """

    def __init__(self, model: SAM2, max_frames_to_track=None):
        self.model = model.eval()
        cfg = model.cfg
        self.num_maskmem = cfg.memory.num_maskmem
        self.max_obj_ptrs = cfg.memory.max_obj_ptrs
        self.mem_dim = cfg.memory.mem_dim
        self.C = cfg.decoder.dim
        self._mem_pos = None

    def init_state(self, frames) -> Dict:
        """frames [T,3,S,S] float in [0,1] at the model's image_size (numpy
        or a tensor; kept on the host until each frame is encoded)."""
        return {"frames": frames, "obj_ids": [], "prompts": {},
                "outputs": {}}

    def add_new_mask(self, state, frame_idx: int, obj_id, mask) -> None:
        if obj_id not in state["obj_ids"]:
            state["obj_ids"].append(obj_id)
        state["prompts"].setdefault(int(frame_idx), {})[obj_id] = \
            torch.as_tensor(mask).to(self.model.device, torch.float32)

    def _frame_feats(self, state, t):
        frame = torch.as_tensor(state["frames"][t:t + 1]).to(
            self.model.device, torch.float32)
        out = self.model.forward_image(frame)
        fpn = out["backbone_fpn"]
        if self._mem_pos is None:
            h, w = fpn[-1].shape[-2:]
            self._mem_pos = sine_pos_embed(h, w, self.mem_dim,
                                           device=fpn[-1].device
                                           ).flatten(1).T
        return fpn, out["vision_pos_enc"][-1]

    @staticmethod
    def _group_signature(state, obj_id):
        return tuple(sorted(t for t, objs in state["prompts"].items()
                            if obj_id in objs))

    def _assemble_memory(self, state, sig, B, t, reverse):
        """[B, M, mem_dim] memory + pos from the conditioning frames
        (temporal slot num_maskmem - 1) and the previous num_maskmem - 1
        frames, plus past object pointers split into C / mem_dim tokens."""
        outputs = state["outputs"]
        tpos = self.model.maskmem_tpos_enc          # [N,1,1,mem]
        mems, poss = [], []
        cond_frames = [ct for ct in sig if (sig, ct) in outputs]
        for ct in cond_frames:
            mems.append(outputs[(sig, ct)].maskmem)
            poss.append(self._mem_pos[None]
                        + tpos[self.num_maskmem - 1].reshape(1, 1, -1))
        for t_pos in range(1, self.num_maskmem):
            t_rel = self.num_maskmem - t_pos
            o = outputs.get((sig, t + t_rel if reverse else t - t_rel))
            if o is None or o.is_cond:
                continue
            mems.append(o.maskmem)
            poss.append(self._mem_pos[None] + tpos[
                self.num_maskmem - t_pos - 1].reshape(1, 1, -1))
        ptrs = [outputs[(sig, ct)].obj_ptr for ct in cond_frames
                if (ct >= t if reverse else ct <= t)]
        for t_diff in range(1, self.max_obj_ptrs):
            o = outputs.get((sig, t + t_diff if reverse else t - t_diff))
            if o is not None and not o.is_cond:
                ptrs.append(o.obj_ptr)
        dev = self.model.device
        hw = self._mem_pos.shape[0]
        mem = (torch.cat(mems, 1) if mems else
               torch.zeros(B, 0, self.mem_dim, device=dev))
        pos = (torch.cat([p.expand(B, hw, self.mem_dim) for p in poss], 1)
               if poss else torch.zeros(B, 0, self.mem_dim, device=dev))
        n_ptr = 0
        if ptrs:
            p = torch.stack(ptrs, 1).reshape(B, -1, self.mem_dim)
            mem = torch.cat([mem, p], 1)
            pos = torch.cat([pos, torch.zeros_like(p)], 1)
            n_ptr = p.shape[1]
        return mem, pos, n_ptr

    @torch.no_grad()
    def propagate_in_video(self, state, start_frame: int = 0,
                           reverse: bool = False):
        m = self.model
        T = state["frames"].shape[0]
        order = (range(start_frame, T) if not reverse
                 else range(start_frame, -1, -1))
        groups: Dict[tuple, List] = {}
        for oid in state["obj_ids"]:
            groups.setdefault(self._group_signature(state, oid),
                              []).append(oid)
        for t in order:
            fpn, pos = self._frame_feats(state, t)
            h, w = fpn[-1].shape[-2:]
            all_ids, all_masks = [], []
            for sig, obj_list in groups.items():
                B = len(obj_list)
                feats = fpn[-1].expand(B, -1, -1, -1)
                high = [fpn[0].expand(B, -1, -1, -1),
                        fpn[1].expand(B, -1, -1, -1)]
                if t in sig:
                    masks = torch.stack([state["prompts"][t][oid]
                                         for oid in obj_list])[:, None]
                    low, hi, _, _, _, obj_ptr, _ = m.use_mask_as_output(
                        feats, high, masks)
                    is_cond = True
                else:
                    mem, mem_pos, n_ptr = self._assemble_memory(
                        state, sig, B, t, reverse)
                    if mem.shape[1] == 0:
                        continue     # not prompted yet on this pass
                    cond = m.condition_features(feats, pos, mem, mem_pos,
                                                n_ptr)
                    _, _, _, low, hi, obj_ptr, _ = m.forward_sam_heads(
                        cond, high_res_features=high, multimask_output=True)
                    is_cond = False
                maskmem = m.encode_new_memory(feats, hi, False)
                state["outputs"][(sig, t)] = FrameOutput(
                    maskmem.flatten(2).transpose(1, 2), obj_ptr, is_cond)
                all_ids.extend(obj_list)
                all_masks.append(low)
            if all_masks:
                yield t, all_ids, torch.cat(all_masks, 0)
