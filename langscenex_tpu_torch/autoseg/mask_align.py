"""Temporally consistent instance masks for a video (auto-mask-align).

Port of the JAX ``langscenex_tpu/autoseg/mask_align.py`` (the reference's
auto-mask-align.py:404-551): the generator proposes masks on the current
keyframe at the chosen level, the reference's NMS (iou 0.8 / score 0.7 /
inner 0.5 on stability x predicted IoU) prunes them, the survivors
prompt the SAM2 video predictor, the masks propagate over the whole video
once per keyframe, and a strided scan of the cached segments looks for a
frame whose uncovered share exceeds the keyframe's by 1 %. At a new
keyframe every live object is re-prompted with its propagated mask and
new regions become new objects. A final forward and reverse propagation
gives per-frame id maps, a distinct-colour palette (colors.npy, with a
black background row) and flat-colour keyframe PNGs.

Masks stay on the models' device until ``run`` returns its id maps;
``save_outputs`` writes them through ``utils/png`` (no PIL);
``build_from_checkpoints`` reads sam_vit_h_4b8939.pth and
sam2_hiera_large.pt with ``torch.load`` into the port's models.
"""
from __future__ import annotations

import colorsys
import dataclasses
import logging
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from ..ops.connected import mask_nms_reference
from ..utils.device import resolve_device
from ..utils.png import write_png

log = logging.getLogger(__name__)

LEVELS = {"default": 0, "small": 1, "middle": 2, "large": 3}


@dataclasses.dataclass
class MaskAlignConfig:
    detect_stride: int = 10       # scan stride (auto-mask-align.py:412)
    uncovered_margin: float = 0.01  # growth over the keyframe baseline
    new_obj_ratio: float = 0.5    # uncovered fraction of a new proposal
    new_obj_min_area: int = 5000  # area_threash (:260)
    level: str = "default"        # which generator level to track
    postnms: bool = True
    postnms_iou: float = 0.8      # (:496)
    postnms_score: float = 0.7
    postnms_inner: float = 0.5
    max_objects: int = 64


def nms_proposals(entries: List[dict], iou_thr: float, score_thr: float,
                  inner_thr: float) -> List[dict]:
    """Score = stability * predicted_iou, then the reference NMS."""
    if not entries:
        return entries
    segs = torch.stack([torch.as_tensor(e["segmentation"])
                        for e in entries])
    scores = torch.tensor(np.array(
        [e["stability_score"] * e["predicted_iou"] for e in entries],
        np.float32), device=segs.device)
    keep = mask_nms_reference(segs, scores, iou_thr, score_thr,
                              inner_thr).cpu().numpy()
    return [e for e, k in zip(entries, keep) if k]


def no_mask_area_ratio(masks: List[torch.Tensor]) -> float:
    """Fraction of pixels covered by no mask."""
    if not masks:
        return 1.0
    cover = torch.zeros_like(torch.as_tensor(masks[0]), dtype=torch.bool)
    for m in masks:
        cover |= torch.as_tensor(m)
    return float(1.0 - int(cover.sum()) / cover.numel())


def search_new_objects(prev_masks: List[torch.Tensor], proposals: List[dict],
                       ratio: float, min_area: int) -> List[torch.Tensor]:
    """Proposals mostly uncovered by the tracked objects, each claiming
    its part of the gap in turn."""
    mask_none = None
    if prev_masks:
        mask_none = torch.ones_like(torch.as_tensor(prev_masks[0]),
                                    dtype=torch.bool)
        for m in prev_masks:
            mask_none &= ~torch.as_tensor(m)
    out = []
    for e in proposals:
        seg = torch.as_tensor(e["segmentation"])
        area = int(seg.sum())
        if area > min_area and mask_none is not None and \
                int((mask_none & seg).sum()) / max(area, 1) > ratio:
            out.append(seg)
            mask_none &= ~seg
    return out


def generate_distinct_colors(n: int, seed: int = 0) -> np.ndarray:
    """[n,3] uint8 palette: hues strided by the golden ratio, saturation
    and value from ``np.random.default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    cols = []
    for i in range(n):
        h = (i * 0.61803398875) % 1.0
        s = 0.6 + 0.4 * float(rng.uniform())
        v = 0.7 + 0.3 * float(rng.uniform())
        cols.append([int(255 * c) for c in colorsys.hsv_to_rgb(h, s, v)])
    return np.array(cols, np.uint8)


def resize_mask(m: torch.Tensor, hw) -> torch.Tensor:
    """Nearest resize by the integer index (i * n_in) // n_out."""
    H, W = hw
    if tuple(m.shape) == (H, W):
        return m
    ys = torch.arange(H, device=m.device) * m.shape[0] // H
    xs = torch.arange(W, device=m.device) * m.shape[1] // W
    return m.index_select(0, ys).index_select(1, xs)


class MaskAligner:
    def __init__(self, amg, predictor, cfg: MaskAlignConfig = MaskAlignConfig()):
        self.amg = amg
        self.predictor = predictor
        self.cfg = cfg

    def run(self, frames: np.ndarray):
        """frames [T,3,H,W] in [0,1] -> (seg_maps [T,H,W] int32 numpy with
        -1 as background, colors [n,3] uint8)."""
        cfg = self.cfg
        T, _, H, W = frames.shape
        lvl = LEVELS.get(cfg.level, 0)
        state = self.predictor.init_state(frames)
        next_obj = 0
        now_frame = 0
        segments: Optional[List[Dict[int, torch.Tensor]]] = None
        while True:
            proposals = self.amg.generate(frames[now_frame])[lvl]
            if cfg.postnms:
                proposals = nms_proposals(proposals, cfg.postnms_iou,
                                          cfg.postnms_score,
                                          cfg.postnms_inner)
            added = 0
            if now_frame == 0:
                for e in proposals[:cfg.max_objects]:
                    self._add(state, 0, next_obj, e["segmentation"], (H, W))
                    next_obj += 1
                    added += 1
            else:
                prev = segments[now_frame]
                for oid, m in sorted(prev.items()):
                    if int(m.sum()) == 0:
                        continue
                    self._add(state, now_frame, oid, m, (H, W))
                new_masks = search_new_objects(
                    [m for _, m in sorted(prev.items())],
                    [dict(e, segmentation=resize_mask(e["segmentation"],
                                                      (H, W)))
                     for e in proposals],
                    cfg.new_obj_ratio, cfg.new_obj_min_area)
                for seg in new_masks:
                    if next_obj >= cfg.max_objects:
                        break
                    self._add(state, now_frame, next_obj, seg, (H, W))
                    next_obj += 1
                    added += 1
            if now_frame == 0 or added:
                segments = self._propagate_all(state, T, (H, W))
            baseline = None
            next_key = -1
            for t in range(0, T, cfg.detect_stride):
                if t < now_frame:
                    continue
                ratio = no_mask_area_ratio(list(segments[t].values()))
                if t == now_frame:
                    baseline = ratio
                elif baseline is not None and \
                        ratio > baseline + cfg.uncovered_margin:
                    next_key = t
                    break
            if next_key < 0 or next_obj >= cfg.max_objects:
                break
            now_frame = next_key

        per_frame = self._propagate_all(state, T, (H, W), final=True)
        colors = generate_distinct_colors(max(next_obj, 1))
        dev = self.predictor.model.device
        seg_maps = torch.full((T, H, W), -1, dtype=torch.int32, device=dev)
        for t in range(T):
            for oid, m in sorted(per_frame[t].items()):
                seg_maps[t][m & (seg_maps[t] == -1)] = oid
        return seg_maps.cpu().numpy(), colors

    def _add(self, state, frame, oid, seg, hw):
        self.predictor.add_new_mask(state, frame, oid,
                                    resize_mask(torch.as_tensor(seg), hw))

    def _propagate_all(self, state, T, hw, final: bool = False
                       ) -> List[Dict[int, torch.Tensor]]:
        """One propagation pass; per frame {obj: mask} at image size.
        ``final`` adds the reverse pass."""
        per_frame: List[Dict[int, torch.Tensor]] = [dict() for _ in range(T)]
        for t, ids, masks in self.predictor.propagate_in_video(state, 0):
            for i, oid in enumerate(ids):
                per_frame[t][oid] = resize_mask(masks[i, 0] > 0, hw)
        if final:
            for t, ids, masks in self.predictor.propagate_in_video(
                    state, T - 1, reverse=True):
                for i, oid in enumerate(ids):
                    if oid not in per_frame[t]:
                        per_frame[t][oid] = resize_mask(masks[i, 0] > 0, hw)
        return per_frame


def save_outputs(seg_maps: np.ndarray, colors: np.ndarray, out_dir: str,
                 keyframes=(0, -1)) -> None:
    """The stage-2 files: per-frame ``{t:04d}_s.npy`` id maps (t from 1),
    ``colors.npy`` (row 0 black for the background, object oid at row
    oid + 1) and flat-colour ``key_{t:04d}.png`` keyframes."""
    os.makedirs(out_dir, exist_ok=True)
    np.save(os.path.join(out_dir, "colors.npy"),
            np.concatenate([np.zeros((1, 3), colors.dtype), colors], 0))
    T = seg_maps.shape[0]
    for t in range(T):
        np.save(os.path.join(out_dir, f"{t + 1:04d}_s.npy"), seg_maps[t])
    for k in keyframes:
        t = k % T
        seg = seg_maps[t]
        img = np.zeros(seg.shape + (3,), np.uint8)
        for oid in np.unique(seg):
            if oid < 0:
                continue
            img[seg == oid] = colors[oid % len(colors)]
        write_png(os.path.join(out_dir, f"key_{t + 1:04d}.png"), img)


def _load(path: str, dev):
    sd = torch.load(path, map_location=dev, weights_only=True)
    return sd.get("model", sd)


def _load_into(model, sd, path):
    missing, unexpected = model.load_state_dict(sd, strict=False)
    if missing:
        raise KeyError(f"{path}: missing {len(missing)} keys, e.g. "
                       f"{missing[:4]}")
    if unexpected:
        log.info("%s: %d keys not used, e.g. %s", path, len(unexpected),
                 unexpected[:4])


def build_from_checkpoints(sam1_ckpt: str, sam2_ckpt: str, amg_cfg=None,
                           image_size: int = 1024,
                           device: torch.device | str | None = None):
    """The proposal + tracking stack from the reference's two torch
    checkpoints (sam_vit_h_4b8939.pth, sam2_hiera_large.pt with its
    weights under ``model``) on ``device`` (the GPU unless the caller
    names another). Returns (SAM1AutomaticMaskGenerator,
    SAM2VideoPredictor); every parameter must be in the checkpoint. Both
    models normalise their input as the reference does (SAM's pixel
    mean/std, ImageNet's), which these checkpoints were trained with."""
    from ..models.sam1 import (SAM1, SAM1AMGConfig, SAM1Config,
                               SAM1AutomaticMaskGenerator)
    from ..models.sam2.model import SAM2, SAM2Config, SAM2VideoPredictor
    dev = resolve_device(device)
    m1 = SAM1(SAM1Config(), device=dev, normalize_input=True)
    _load_into(m1, _load(sam1_ckpt, dev), sam1_ckpt)
    m2 = SAM2(SAM2Config(image_size=image_size), device=dev,
              normalize_input=True)
    _load_into(m2, _load(sam2_ckpt, dev), sam2_ckpt)
    return (SAM1AutomaticMaskGenerator(m1, amg_cfg or SAM1AMGConfig()),
            SAM2VideoPredictor(m2))
