"""OpenSeg / CLIP language-feature extraction, port of the JAX
``models/openseg.py`` (the reference's field_construction/preprocessor.py
extract_with_openseg :22-90): per frame, a dense extractor gives [C,H,W]
per-pixel CLIP-aligned embeddings, which are mean-pooled per segment id
(the ``*_s.npy`` ids, from -1 upward) and L2-normalised into [n_segs, C]
rows, saved as ``lang_features/%04d.npy``.

The OpenSeg TF SavedModel is an external artifact of about 2 GB: the port
keeps its filesystem contract and runs it only where ``tensorflow`` and
the model are present (``tensorflow`` is imported inside
``OpenSegExtractor`` and nowhere else). ``models/clip_dense.
ClipDenseExtractor`` serves the same contract on the card.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch


def mask_pool_features(feat, seg: np.ndarray) -> np.ndarray:
    """[C,H,W] features (numpy or a tensor on any device, pooled there) +
    [H,W] seg ids -> [n_present, C] L2-normalised per-segment means, rows
    by seg id from -1 upward, absent ids skipped (preprocessor.py:
    79-90)."""
    feat = torch.as_tensor(feat)
    C = feat.shape[0]
    flat = feat.reshape(C, -1).float()                      # [C, HW]
    ids = torch.as_tensor(np.asarray(seg).reshape(-1).astype(np.int64) + 1,
                          device=flat.device)
    n = int(seg.max()) + 2
    sums = torch.zeros(C, n, device=flat.device).index_add_(1, ids, flat)
    counts = torch.zeros(n, device=flat.device).index_add_(
        0, ids, torch.ones_like(flat[0]))
    means = sums / torch.clamp(counts, min=1.0)
    rows = means[:, counts > 0].T.cpu().numpy()
    norms = np.linalg.norm(rows, axis=-1, keepdims=True)
    return rows / np.maximum(norms, 1e-12)


class OpenSegExtractor:
    """The OpenSeg TF SavedModel where ``tensorflow`` and the model
    directory are present; a ``RuntimeError`` naming tensorflow
    otherwise."""

    def __init__(self, model_path: str):
        try:
            import tensorflow as tf
        except ImportError as e:
            raise RuntimeError(
                "tensorflow is not available: provide precomputed "
                "lang_features/*.npy (the preprocessor.py contract) or use "
                "models/clip_dense.ClipDenseExtractor") from e
        self._tf = tf
        self._model = tf.saved_model.load(model_path, tags=["serve"])

    def extract(self, image_bytes: bytes, hw) -> np.ndarray:
        tf = self._tf
        res = self._model.signatures["serving_default"](
            inp_image_bytes=tf.convert_to_tensor(image_bytes),
            inp_text_emb=tf.zeros([1, 1, 768]))
        info = res["image_info"]
        crop = (int(info[0, 0] * info[2, 0]), int(info[0, 1] * info[2, 1]))
        feat = res["image_embedding_feat"][:, :crop[0], :crop[1]]
        feat = tf.image.resize(feat, hw, method="nearest")[0]
        return np.asarray(feat, np.float32).transpose(2, 0, 1)


def extract_scene_features(data_path: str, model_path: Optional[str] = None,
                           extractor=None) -> None:
    """The head of stage 3: per input frame, extract, mask-pool by its
    ``*_s.npy`` ids and save lang_features/%04d.npy (preprocessor.py
    :22-90). Without ``extractor``, OpenSeg at ``model_path``."""
    input_dir = os.path.join(data_path, "input")
    seg_dir = os.path.join(data_path, "lang_features_dim3")
    out_dir = os.path.join(data_path, "lang_features")
    os.makedirs(out_dir, exist_ok=True)
    if extractor is None:
        extractor = OpenSegExtractor(model_path)
    names = sorted(n for n in os.listdir(input_dir)
                   if n.endswith((".png", ".jpg")))
    for i, name in enumerate(names):
        seg = np.load(os.path.join(seg_dir, f"{i + 1:04d}_s.npy"))
        if seg.ndim == 3:
            seg = seg[0]
        with open(os.path.join(input_dir, name), "rb") as f:
            img_bytes = f.read()
        np.save(os.path.join(out_dir, f"{i + 1:04d}.npy"),
                mask_pool_features(extractor.extract(img_bytes, seg.shape),
                                   seg))
