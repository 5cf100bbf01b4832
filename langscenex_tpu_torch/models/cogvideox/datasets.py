"""Fine-tune datasets for the TriMap diffusion and VAE stages.

Port of the JAX ``models/cogvideox/datasets.py`` (numpy and PIL, no
framework): the clip sampler of the reference's ImageVideoDataset (49
frames at stride 2, the VAE's 4k+1 frame count, first/last-frame
conditioning pairs), AutoEncoderDataset and the single-image dataset,
over directories of frames. The same seed gives the same samples as the
JAX package.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np


def valid_clip_length(n: int) -> int:
    """Largest f <= n with f % 4 == 1 (the VAE's 4k+1 temporal
    constraint)."""
    return n - ((n - 1) % 4)


def load_image(path: str, size_hw: Tuple[int, int]) -> np.ndarray:
    """An image file as [3, H, W] float32 in [-1, 1]."""
    from PIL import Image
    H, W = size_hw
    im = Image.open(path).convert("RGB").resize((W, H))
    return np.asarray(im, np.float32).transpose(2, 0, 1) / 127.5 - 1.0


def _frames(root: str) -> List[str]:
    return sorted(os.path.join(root, f) for f in os.listdir(root)
                  if f.endswith((".png", ".jpg")))


@dataclasses.dataclass
class ClipSamplerConfig:
    num_frames: int = 49
    stride: int = 2
    size_hw: Tuple[int, int] = (480, 720)


class VideoClipDataset:
    """Samples (clip [F,3,H,W], first_frame, last_frame) training tuples
    from frame directories."""

    def __init__(self, roots: Sequence[str],
                 cfg: ClipSamplerConfig = ClipSamplerConfig(),
                 seed: int = 0):
        self.cfg = cfg
        need = (cfg.num_frames - 1) * cfg.stride + 1
        self.videos = [f for f in map(_frames, roots) if len(f) >= need]
        self.rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return len(self.videos)

    def sample(self, idx: Optional[int] = None):
        idx = int(self.rng.integers(len(self.videos))) if idx is None else idx
        frames = self.videos[idx]
        need = (self.cfg.num_frames - 1) * self.cfg.stride + 1
        start = int(self.rng.integers(len(frames) - need + 1))
        sel = frames[start:start + need:self.cfg.stride]
        clip = np.stack([load_image(p, self.cfg.size_hw) for p in sel])
        return clip, clip[0], clip[-1]

    def __iter__(self) -> Iterator:
        while True:
            yield self.sample()


class AutoEncoderDataset:
    """Short fixed-length clips for VAE training: num_frames consecutive
    frames, 4k+1 enforced."""

    def __init__(self, roots: Sequence[str], num_frames: int = 17,
                 size_hw: Tuple[int, int] = (240, 360), seed: int = 0):
        self.inner = VideoClipDataset(
            roots, ClipSamplerConfig(num_frames=valid_clip_length(num_frames),
                                     stride=1, size_hw=size_hw), seed)

    def __len__(self):
        return len(self.inner)

    def sample(self, idx: Optional[int] = None) -> np.ndarray:
        clip, _, _ = self.inner.sample(idx)
        return clip


class ImageFolderDataset:
    """Single images as 1-frame clips, for image-regularised VAE
    training."""

    def __init__(self, root: str, size_hw: Tuple[int, int] = (240, 360),
                 seed: int = 0):
        self.paths = _frames(root)
        self.size_hw = size_hw
        self.rng = np.random.default_rng(seed)

    def __len__(self):
        return len(self.paths)

    def sample(self, idx: Optional[int] = None) -> np.ndarray:
        idx = int(self.rng.integers(len(self.paths))) if idx is None else idx
        return load_image(self.paths[idx], self.size_hw)[None]
