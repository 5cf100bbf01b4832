"""auto-seg CLI (the reference's auto-mask-align.py:404-426 arguments).

  python -m langscenex_tpu_torch.autoseg \\
      --sam1_checkpoint sam_vit_h_4b8939.pth \\
      --sam2_checkpoint sam2_hiera_large.pt \\
      --video_path demo/rgb --output_dir demo/seg --level default

Port of the JAX ``langscenex_tpu/autoseg/__main__.py``. ``video_path`` is
a directory of PNG frames (a JPEG frame raises ``ValueError``: frames are
read by ``utils/png``, not PIL) or a video file, which ``ffmpeg`` (run as
a subprocess) splits into PNGs; without ``ffmpeg`` that raises. Frames
are resized to the square model size with PIL's bicubic, the id maps
back to the frame size with PIL's nearest, both exactly as Pillow does
them. Writes per-frame ``*_s.npy`` id maps, ``colors.npy`` (background
row 0) and flat-colour keyframe PNGs to ``output_dir``. Runs on the
first CUDA card unless ``--device`` names another.
"""
from __future__ import annotations

import argparse
import logging
import os
import shutil
import subprocess
import tempfile

import numpy as np

from ..utils.png import read_png, resize_bicubic, resize_nearest, to_rgb

log = logging.getLogger("autoseg")


def _read_frames(path: str, square: int):
    names = sorted(n for n in os.listdir(path)
                   if n.endswith((".png", ".jpg")))
    raws = [to_rgb(read_png(os.path.join(path, n))) for n in names]
    H, W = raws[0].shape[:2]
    frames = np.stack([
        resize_bicubic(r, (square, square)).astype(np.float32)
        .transpose(2, 0, 1) / 255.0 for r in raws])
    return frames, (H, W)


def load_frames(path: str, square: int) -> tuple:
    """A frame directory (or a video through ffmpeg) -> (frames [T,3,S,S]
    float32 in [0,1], the frames' (H, W))."""
    if os.path.isdir(path):
        return _read_frames(path, square)
    if shutil.which("ffmpeg") is None:
        raise RuntimeError(f"{path} is not a frame directory, and "
                           f"splitting a video needs ffmpeg, which is not "
                           f"on the PATH")
    with tempfile.TemporaryDirectory() as tmp:
        subprocess.run(["ffmpeg", "-y", "-i", path,
                        os.path.join(tmp, "%04d.png")],
                       check=True, capture_output=True)
        return _read_frames(tmp, square)


def resize_id_maps(seg_maps: np.ndarray, hw) -> np.ndarray:
    """[T,h,w] int32 id maps -> [T,H,W] (PIL's nearest, mode "I")."""
    H, W = hw
    return np.stack([resize_nearest(s.astype(np.int32), (W, H))
                     for s in seg_maps]).astype(np.int32)


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO)
    p = argparse.ArgumentParser()
    p.add_argument("--sam1_checkpoint", required=True)
    p.add_argument("--sam2_checkpoint", required=True)
    p.add_argument("--video_path", required=True)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--level", default="default",
                   choices=("default", "small", "middle", "large"))
    p.add_argument("--detect_stride", type=int, default=10)
    p.add_argument("--image_size", type=int, default=1024)
    p.add_argument("--device", default=None,
                   help="torch device (default: the first CUDA card)")
    args = p.parse_args(argv)

    from .mask_align import (MaskAligner, MaskAlignConfig,
                             build_from_checkpoints, save_outputs)

    amg, pred = build_from_checkpoints(
        args.sam1_checkpoint, args.sam2_checkpoint,
        image_size=args.image_size, device=args.device)
    frames, hw = load_frames(args.video_path, args.image_size)
    aligner = MaskAligner(amg, pred, MaskAlignConfig(
        level=args.level, detect_stride=args.detect_stride))
    seg_maps, colors = aligner.run(frames)
    seg_maps = resize_id_maps(seg_maps, hw)
    save_outputs(seg_maps, colors, args.output_dir)
    log.info("wrote %d frames, %d objects -> %s",
             len(seg_maps), len(colors), args.output_dir)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
