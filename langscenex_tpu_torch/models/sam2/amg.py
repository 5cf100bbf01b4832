"""Automatic mask generation (SAM1-style grid prompting) through SAM2.

Port of the JAX ``langscenex_tpu/models/sam2/amg.py`` (the modified SAM1
automatic mask generator the reference vendors, which returns FOUR
granularity levels): a regular point grid is decoded in batches through
the SAM2 mask decoder on no-memory features, four candidate masks per
point (the stability-selected single-mask token, then the three
multimask tokens = small / medium / large), then quality filtering and
mask NMS per level. Masks stay on the model's device.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np
import torch

from ...ops.connected import mask_nms
from .model import SAM2


@dataclasses.dataclass(frozen=True)
class AMGConfig:
    points_per_side: int = 32
    points_per_batch: int = 64
    pred_iou_thresh: float = 0.7
    stability_score_thresh: float = 0.85
    stability_offset: float = 1.0
    nms_iou_thresh: float = 0.9
    min_mask_area: int = 50


def point_grid(n: int) -> np.ndarray:
    """[n*n, 2] normalized (x, y) grid points."""
    step = 1.0 / (2 * n)
    xs = np.linspace(step, 1 - step, n)
    gx, gy = np.meshgrid(xs, xs, indexing='xy')
    return np.stack([gx, gy], -1).reshape(-1, 2).astype(np.float32)


def stability_score(logits: torch.Tensor, offset: float) -> torch.Tensor:
    """IoU between the masks thresholded at +offset and -offset."""
    hi = (logits > offset).sum((-2, -1)).float()
    lo = (logits > -offset).sum((-2, -1)).float()
    return hi / torch.clamp(lo, min=1.0)


def nms_levels(levels: List[List[Dict]], thresh: float
               ) -> Tuple[List[Dict], ...]:
    """Mask NMS by predicted IoU within each level."""
    out = []
    for entries in levels:
        if not entries:
            out.append([])
            continue
        m = torch.stack([e["segmentation"] for e in entries])
        sc = torch.tensor([e["predicted_iou"] for e in entries],
                          dtype=torch.float32, device=m.device)
        keep = mask_nms(m, sc, thresh).cpu().numpy()
        out.append([e for e, k in zip(entries, keep) if k])
    return tuple(out)


class AutomaticMaskGenerator:
    def __init__(self, model: SAM2, cfg: AMGConfig = AMGConfig()):
        self.model = model.eval()
        self.cfg = cfg
        self.image_size = model.cfg.image_size

    @torch.no_grad()
    def _decode(self, fpn, coords):
        m = self.model
        B = coords.shape[0]
        feats = m.add_no_mem_embed(fpn[-1].expand(B, -1, -1, -1))
        high = [fpn[0].expand(B, -1, -1, -1), fpn[1].expand(B, -1, -1, -1)]
        labels = torch.ones(B, 1, dtype=torch.int32, device=coords.device)
        m3, _, i3 = m.forward_sam_heads(feats, coords[:, None], labels, None,
                                        high, True)[:3]
        m1, _, i1 = m.forward_sam_heads(feats, coords[:, None], labels, None,
                                        high, False)[:3]
        return torch.cat([m1, m3], 1), torch.cat([i1, i3], 1)

    @torch.no_grad()
    def generate(self, image) -> Tuple[List[Dict], ...]:
        """image [3,S,S] in [0,1] -> 4 lists (default, small, medium,
        large) of {segmentation [S/4, S/4] bool tensor, predicted_iou,
        stability_score}."""
        cfg = self.cfg
        dev = self.model.device
        img = torch.as_tensor(image).to(dev, torch.float32)
        fpn = self.model.forward_image(img[None])["backbone_fpn"]
        grid = point_grid(cfg.points_per_side) * self.image_size
        levels: List[List[Dict]] = [[] for _ in range(4)]
        for s in range(0, grid.shape[0], cfg.points_per_batch):
            pts = torch.from_numpy(grid[s:s + cfg.points_per_batch]).to(dev)
            masks, ious = self._decode(fpn, pts)
            stab = stability_score(masks, cfg.stability_offset)
            seg_all = masks > 0
            area = seg_all.sum((-2, -1)).cpu().numpy()
            ious_h, stab_h = ious.cpu().numpy(), stab.cpu().numpy()
            for lvl in range(4):
                keep = ((ious_h[:, lvl] > cfg.pred_iou_thresh)
                        & (stab_h[:, lvl] > cfg.stability_score_thresh))
                for b in np.nonzero(keep)[0]:
                    if area[b, lvl] < cfg.min_mask_area:
                        continue
                    levels[lvl].append({
                        "segmentation": seg_all[b, lvl],
                        "predicted_iou": float(ious_h[b, lvl]),
                        "stability_score": float(stab_h[b, lvl])})
        return nms_levels(levels, cfg.nms_iou_thresh)
