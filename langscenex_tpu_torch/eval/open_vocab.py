"""Open-vocabulary query metrics over rendered language-feature maps,
port of the metric half of the JAX ``eval/open_vocab.py`` (numpy): the
per-pixel cosine relevancy of each query's 3-d code, the predicted masks,
per-query IoU, mIoU and localization accuracy (the paper's headline
metrics, SURVEY.md §3.5).

``embed_queries`` and ``encode_queries_to_lang3`` need the CLIP text
tower and the scene autoencoder, which belong to the pose and language
lifting stage (ROADMAP Queue 1, D1); they raise until that stage is
ported.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np


def embed_queries(texts: Sequence[str], text_encoder, params,
                  tokenizer) -> np.ndarray:
    """texts -> [Q, proj_dim] CLIP text embeddings (needs D1's CLIP
    text tower)."""
    raise NotImplementedError("embed_queries needs the CLIP text tower, "
                              "ported with the language-lifting stage (D1)")


def encode_queries_to_lang3(query_emb: np.ndarray, ae_trainer
                            ) -> np.ndarray:
    """[Q, 768] CLIP embeddings -> [Q, 3] scene-AE codes (needs D1's
    scene autoencoder)."""
    raise NotImplementedError("encode_queries_to_lang3 needs the scene "
                              "autoencoder, ported with the "
                              "language-lifting stage (D1)")


def relevancy_maps(lang_map: np.ndarray, query_codes: np.ndarray,
                   min_norm: float = 0.1) -> np.ndarray:
    """lang_map [3,H,W] rendered features + [Q,3] codes -> [Q,H,W]
    cosine relevancy. Pixels whose feature norm is below ``min_norm``
    (uncovered background: alpha-blended features decay toward 0 there,
    and normalizing them amplifies noise into spurious matches) get
    relevancy -1."""
    C, H, W = lang_map.shape
    flat = lang_map.reshape(C, -1)
    norms = np.linalg.norm(flat, axis=0, keepdims=True)
    flat = flat / np.maximum(norms, 1e-12)
    q = query_codes / np.maximum(
        np.linalg.norm(query_codes, axis=-1, keepdims=True), 1e-12)
    rel = q @ flat
    rel = np.where(norms >= min_norm, rel, -1.0)
    return rel.reshape(-1, H, W)


def predict_masks(rel: np.ndarray, threshold: float = 0.5) -> np.ndarray:
    """[Q,H,W] relevancy -> [H,W] predicted query index, -1 where no query
    clears the threshold (background)."""
    best = np.argmax(rel, axis=0)
    top = np.max(rel, axis=0)
    return np.where(top >= threshold, best, -1).astype(np.int32)


def iou_per_query(pred: np.ndarray, gt: np.ndarray, n_queries: int
                  ) -> np.ndarray:
    """[H,W] predicted vs ground-truth query-index maps -> [Q] IoU
    (NaN for queries absent from both)."""
    out = np.full(n_queries, np.nan, np.float64)
    for q in range(n_queries):
        p = pred == q
        g = gt == q
        union = (p | g).sum()
        if union:
            out[q] = (p & g).sum() / union
    return out


def eval_open_vocab(lang_maps: Sequence[np.ndarray],
                    gt_maps: Sequence[np.ndarray],
                    query_codes: np.ndarray,
                    threshold: float = 0.5) -> Dict[str, float]:
    """Per-view rendered lang maps [3,H,W] + ground-truth query-index
    maps [H,W] -> {miou, acc} (acc = localization accuracy: fraction of
    gt-present queries whose argmax-relevancy pixel lands inside the gt
    mask — the paper's second metric)."""
    ious: List[float] = []
    hits = 0
    total = 0
    Q = query_codes.shape[0]
    for lang, gt in zip(lang_maps, gt_maps):
        rel = relevancy_maps(lang, query_codes)
        pred = predict_masks(rel, threshold)
        iou = iou_per_query(pred, gt, Q)
        ious.extend(iou[np.isfinite(iou)].tolist())
        for q in range(Q):
            g = gt == q
            if not g.any():
                continue
            total += 1
            peak = np.unravel_index(np.argmax(rel[q]), rel[q].shape)
            hits += bool(g[peak])
    return {"miou": float(np.mean(ious)) if ious else float("nan"),
            "acc": hits / total if total else float("nan")}
