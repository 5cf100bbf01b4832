"""Connected components, hole and island removal, and mask NMS.

Port of the JAX ``langscenex_tpu/ops/connected.py`` (which replaces the
reference's union-find CUDA labelling, sam2/csrc/connected_components.cu,
with min-label propagation):

- ``connected_components`` seeds every foreground pixel with its linear
  index and takes the minimum over each 3x3 neighbourhood (int32 minima of
  shifted slices, exact at any label count) until nothing changes or
  ``max_iters`` passes have run, as the JAX loop does: the labels are the
  ones of that capped iteration, not scipy's;
- ``mask_nms`` (greedy IoU + containment) and ``mask_nms_reference`` (the
  reference auto-mask-align NMS) order by a stable descending sort of the
  scores, so tied scores keep their input order; their [N, N] overlap
  matrices are matmuls on the masks' device, and ``mask_nms``'s greedy
  scan runs over those matrices on the host.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

INF = 2 ** 30
CHECK_EVERY = 8         # propagation passes between fixpoint tests


def _min3x3(labels: torch.Tensor) -> torch.Tensor:
    H, W = labels.shape
    p = F.pad(labels, (1, 1, 1, 1), value=INF)
    out = labels
    for dy in range(3):
        for dx in range(3):
            out = torch.minimum(out, p[dy:dy + H, dx:dx + W])
    return out


def connected_components(mask: torch.Tensor, max_iters: int = 256
                         ) -> torch.Tensor:
    """[H,W] bool -> [H,W] int32 labels (background -1): the minimum
    linear index of each 8-connected component, after at most
    ``max_iters`` propagation passes. The fixpoint is tested every
    CHECK_EVERY passes (one host sync each); passes after it change
    nothing."""
    H, W = mask.shape
    idx = torch.arange(H * W, dtype=torch.int32,
                       device=mask.device).reshape(H, W)
    inf = torch.full_like(idx, INF)
    labels = torch.where(mask, idx, inf)
    it = 0
    while it < max_iters:
        prev = labels
        for _ in range(min(CHECK_EVERY, max_iters - it)):
            labels = torch.where(mask, _min3x3(labels), inf)
            it += 1
        if torch.equal(labels, prev):
            break
    return torch.where(mask, labels, torch.full_like(labels, -1))


def component_areas(labels: torch.Tensor) -> torch.Tensor:
    """[H,W] labels -> [H,W] area of each pixel's component (0 on the
    background)."""
    H, W = labels.shape
    flat = labels.reshape(-1).long()
    safe = torch.where(flat < 0, H * W, flat)
    counts = torch.bincount(safe, minlength=H * W + 1)
    return torch.where(flat >= 0, counts[safe], 0).reshape(H, W).to(
        torch.int32)


def remove_small_regions(mask: torch.Tensor, area_thresh: int,
                         mode: str = "holes") -> torch.Tensor:
    """'holes' fills background components smaller than ``area_thresh``;
    'islands' removes foreground components smaller than it."""
    work = ~mask if mode == "holes" else mask
    areas = component_areas(connected_components(work))
    small = work & (areas < area_thresh)
    return mask | small if mode == "holes" else mask & ~small


def _overlaps(masks: torch.Tensor):
    f = masks.reshape(masks.shape[0], -1).float()
    return f @ f.T, f.sum(-1)


def mask_iou_matrix(masks: torch.Tensor) -> torch.Tensor:
    """[N,H,W] bool -> [N,N] IoU."""
    inter, area = _overlaps(masks)
    union = area[:, None] + area[None, :] - inter
    return inter / torch.clamp(union, min=1.0)


def mask_inner_matrix(masks: torch.Tensor) -> torch.Tensor:
    """[N,N] intersection / area_j (the containment of j in i)."""
    inter, area = _overlaps(masks)
    return inter / torch.clamp(area[None, :], min=1.0)


def mask_nms(masks: torch.Tensor, scores: torch.Tensor,
             iou_thresh: float = 0.9, inner_thresh: float = 0.9
             ) -> torch.Tensor:
    """Greedy mask NMS with IoU and containment suppression. Returns keep
    [N] bool (on the masks' device) in the input order."""
    n = masks.shape[0]
    order = torch.argsort(-scores.to(masks.device), stable=True)
    inter, area = _overlaps(masks[order])
    union = area[:, None] + area[None, :] - inter
    iou = (inter / torch.clamp(union, min=1.0)).cpu().numpy()
    inner = (inter / torch.clamp(area[None, :], min=1.0)).cpu().numpy()
    sup_all = (iou > iou_thresh) | (inner > inner_thresh)
    keep = np.ones(n, bool)
    later = np.arange(n)
    for i in range(n):
        if keep[i]:
            keep &= ~(sup_all[i] & (later > i))
    out = torch.zeros(n, dtype=torch.bool, device=masks.device)
    out[order] = torch.from_numpy(keep).to(masks.device)
    return out


def mask_nms_reference(masks: torch.Tensor, scores: torch.Tensor,
                       iou_thr: float = 0.7, score_thr: float = 0.1,
                       inner_thr: float = 0.2) -> torch.Tensor:
    """The reference's proposal NMS (auto-mask-align.py mask_nms:50-129):
    sorted by score, a mask is suppressed by (a) IoU with any
    higher-scored mask, (b) a low score, (c) the 'inner IoU'
    1 - (I/area_i)(I/area_j) gated on I/area_i < 0.5 and I/area_j >= 0.85,
    in the upper triangle and in the lower triangle with its superdiagonal
    (``tril(k=1)``, as the JAX package has it). A criterion that would
    suppress everything keeps the three best-scored masks instead.
    Returns keep [N] bool in the input order."""
    n = masks.shape[0]
    dev = masks.device
    scores = scores.to(dev)
    order = torch.argsort(-scores, stable=True)
    s = scores[order]
    inter, area = _overlaps(masks[order])
    union = area[:, None] + area[None, :] - inter
    iou = inter / torch.clamp(union, min=1.0)
    row_inter = inter / torch.clamp(area[:, None], min=1.0)
    col_inter = inter / torch.clamp(area[None, :], min=1.0)
    gate = (row_inter < 0.5) & (col_inter >= 0.85)
    inner = torch.where(gate, 1.0 - row_inter * col_inter,
                        torch.zeros_like(inter))
    ones = torch.ones((n, n), dtype=torch.bool, device=dev)
    triu1, tril1 = torch.triu(ones, 1), torch.tril(ones, 1)
    zero = torch.zeros_like(inter)
    iou_max = torch.where(triu1, iou, zero).amax(0)
    inner_max_u = torch.where(triu1, inner, zero).amax(0)
    inner_max_l = torch.where(tril1, inner, zero).amax(0)

    top3 = torch.arange(n, device=dev) < 3

    def fallback(k):
        return k if bool(k.any()) else top3
    keep = ((iou_max <= iou_thr) & fallback(s > score_thr)
            & fallback(inner_max_u <= 1 - inner_thr)
            & fallback(inner_max_l <= 1 - inner_thr))
    out = torch.zeros(n, dtype=torch.bool, device=dev)
    out[order] = keep
    return out
