"""The LSeg branch's feature extractor, port of the JAX ``models/lseg.py``
(the reference's alternate language branch, field_construction/
preprocessor.py:112-138, 229-255).

The reference imports ``cogvideox_interpolation.lseg``, a module absent
from its tree; its call sites fix the contract: ``extract_features(img)``
gives [1, 512, H, W] per-pixel CLIP-aligned features of a 640x480 frame
normalised to mean/std 0.5, which a diffusers ``VQModel`` (512 -> 4
channels) compresses to ``lang_features_dim4/*_f.npy``. As in the JAX
package, the backbone is the dense CLIP vision tower
(``models/clip_dense.CLIPVisionDense``): its dense tokens, L2-normalised
per pixel, cut or zero-padded to ``out_dim`` channels and resized to the
frame with ``jax.image.resize``'s antialiased bilinear
(``ops/interp.resize_linear``).
"""
from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.interp import resize_linear
from .clip_dense import CLIPVisionConfig, CLIPVisionDense


class LSegFeatureExtractor:
    """image [H,W,3] -> [1, out_dim, H', W'] features. ``model`` is a
    ``CLIPVisionDense`` (or its state_dict in HF's keys)."""

    def __init__(self, model, cfg: CLIPVisionConfig = CLIPVisionConfig(),
                 out_dim: int = 512,
                 device: torch.device | str | None = None):
        if isinstance(model, dict):
            sd = model
            model = CLIPVisionDense(cfg, device=device)
            model.load_state_dict(sd, strict=True)
        self.model = model.eval()
        self.cfg = model.cfg
        self.out_dim = out_dim

    @classmethod
    def from_torch_checkpoint(cls, path: str, cfg=CLIPVisionConfig(),
                              device: torch.device | str | None = None,
                              **kw):
        sd = torch.load(path, map_location="cpu", weights_only=True)
        return cls(sd, cfg, device=device, **kw)

    @torch.no_grad()
    def extract_features(self, image: np.ndarray,
                         out_hw: Optional[Tuple[int, int]] = None
                         ) -> torch.Tensor:
        """image: [H,W,3] float in [-1, 1] (the reference's 0.5/0.5
        normalisation) or uint8; returns [1, out_dim, H', W'] on the
        model's device, (H', W') = out_hw or the input's size."""
        if image.dtype == np.uint8:
            image = (image.astype(np.float32) / 255.0 - 0.5) / 0.5
        H, W = image.shape[:2]
        out_hw = tuple(out_hw or (H, W))
        # the backbone takes patch multiples: bilinear to the nearest ones
        ps = self.cfg.patch_size
        Hp = max(ps, round(H / ps) * ps)
        Wp = max(ps, round(W / ps) * ps)
        x = torch.from_numpy(np.ascontiguousarray(
            image.transpose(2, 0, 1), np.float32)).to(self.model.device)
        dense = self.model(resize_linear(x, (Hp, Wp))[None])[1]
        feats = dense / (torch.linalg.vector_norm(dense, dim=1,
                                                  keepdim=True) + 1e-8)
        C = feats.shape[1]
        if C > self.out_dim:
            feats = feats[:, :self.out_dim]
        elif C < self.out_dim:
            feats = F.pad(feats, (0, 0, 0, 0, 0, self.out_dim - C))
        return resize_linear(feats, out_hw)


def generate_lang_features_with_lseg(data_path: str, lseg, vq_model,
                                     resolution=(640, 480)) -> int:
    """The reference's LSeg branch (preprocessor.py:229-255): every input
    frame resized to ``resolution`` (PIL's bicubic, ``utils/png.
    resize_bicubic``), its LSeg features VQ-encoded to the continuous
    4-channel latents, saved as ``lang_features_dim4/{name}_f.npy``
    [1, 4, h, w]. Returns the frame count. (The reference's cameras read
    ``lang_features_dim3``; these maps are made and not read there
    either.)"""
    from ..utils.png import read_png, resize_bicubic, to_rgb
    imgs = os.path.join(data_path, "input")
    names = sorted(x for x in os.listdir(imgs)
                   if x.endswith(("png", "jpg")))
    save = os.path.join(data_path, "lang_features_dim4")
    os.makedirs(save, exist_ok=True)
    vq_model.eval()
    for name in names:
        arr = resize_bicubic(to_rgb(read_png(os.path.join(imgs, name))),
                             tuple(resolution))
        feats = lseg.extract_features(arr)                  # [1,512,H,W]
        with torch.no_grad():
            z = vq_model.encode(feats.to(next(vq_model.parameters())
                                         .device))
        np.save(os.path.join(save, f"{name.split('.')[0]}_f.npy"),
                z.cpu().numpy())
    return len(names)
