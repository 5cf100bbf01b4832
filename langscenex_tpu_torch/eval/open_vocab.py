"""Open-vocabulary queries over rendered language-feature maps, port of
the JAX ``eval/open_vocab.py`` (numpy, with the CLIP text tower and the
scene autoencoder in torch). The protocol (SURVEY.md §3.5; the reference
ships no query code):

  text --CLIP text tower--> 768-d --scene AE encoder--> 3-d code
  per pixel: cosine(rendered lang3, code) -> per-query relevancy
  argmax over queries (+ a background threshold) -> predicted masks
  predicted vs ground-truth id maps -> per-query IoU, mIoU and the
  localisation accuracy (the paper's headline metrics).

``embed_queries`` tokenises with the caller's tokenizer (HF's
CLIPTokenizer, or any callable returning ``input_ids``); ``embed_ids``
takes token ids and needs no ``transformers``.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch


def embed_ids(ids, text_encoder) -> np.ndarray:
    """[Q, T] token ids -> [Q, proj_dim] L2-normalised CLIP text
    embeddings (``models/clip_dense.CLIPTextEncoder``)."""
    ids = torch.as_tensor(np.asarray(ids), dtype=torch.long,
                          device=text_encoder.device)
    with torch.no_grad():
        emb = text_encoder(ids).float().cpu().numpy()
    return emb / np.maximum(np.linalg.norm(emb, axis=-1, keepdims=True),
                            1e-12)


def embed_queries(texts: Sequence[str], text_encoder,
                  tokenizer) -> np.ndarray:
    """texts -> [Q, proj_dim] L2-normalised CLIP text embeddings, padded
    to the tower's ``max_positions``."""
    batch = tokenizer(list(texts), padding="max_length",
                      max_length=text_encoder.cfg.max_positions,
                      truncation=True, return_tensors="np")
    return embed_ids(batch["input_ids"], text_encoder)


def encode_queries_to_lang3(query_emb: np.ndarray, ae_trainer
                            ) -> np.ndarray:
    """[Q, 768] CLIP embeddings -> [Q, 3] scene-AE codes (the compression
    the per-pixel features went through; L2-normalised by the encoder)."""
    return ae_trainer.encode(np.asarray(query_emb, np.float32))


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
