"""Normal keyframes from VGGT's depth, port of the JAX ``get_normal.py``.

The reference (get_normal.py:18-23) loads StableNormal through
``torch.hub`` and writes one normal PNG per RGB keyframe. The JAX package
replaces that external diffusion model with normals derived from the
depth head of VGGT (the model that also initialises the poses): the
cross products of the unprojected camera-space point grid
(``ops/depth_normal.normal_from_depth``, the operator of the trainer's
depth-normal loss). The PNG follows StableNormal's contract as
``scene/cameras.Camera.load_normal`` decodes it (n = -(2x - 1)), so a
normal n is stored as x = (1 - n) / 2, written back at the keyframe's own
size with PIL's nearest resize (``utils/png.resize_nearest``).

CLI::

    python -m langscenex_tpu_torch.get_normal --base_path SCENE \\
        --vggt_checkpoint model.pt [--config JSON] [--device cpu]

reads ``SCENE/rgb/*.png`` and writes ``SCENE/normal/%04d.png``. The
checkpoint is a state_dict in facebook/VGGT-1B's keys, read with
``torch.load(weights_only=True)``; ``--config`` overrides fields of
``VGGTConfig`` (VGGT-1B by default) as a JSON object.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os

import numpy as np
import torch

from .utils.png import png_size, resize_nearest, write_png

log = logging.getLogger(__name__)


def generate_normals(base_path: str, model=None, cfg=None,
                     rgb_dir: str = "rgb", out_dir: str = "normal",
                     device: torch.device | str | None = None) -> dict:
    """For each base_path/rgb_dir/*.png write base_path/out_dir/%04d.png.
    ``model``: a VGGT or its state_dict (loaded into ``VGGT(cfg)``).
    Returns the model's outputs."""
    from .ops.depth_normal import normal_from_depth
    from .pose_estimation import _square, load_frames, load_vggt, run_vggt
    model = load_vggt(model, cfg, device)
    in_dir = os.path.join(base_path, rgb_dir)
    paths = [os.path.join(in_dir, n) for n in sorted(os.listdir(in_dir))
             if n.endswith((".png", ".jpg"))]
    out = run_vggt(model, load_frames(paths, _square(model.cfg)))
    od = os.path.join(base_path, out_dir)
    os.makedirs(od, exist_ok=True)
    for i, p in enumerate(paths):
        n = normal_from_depth(out["depth"][i], out["K"][i]).cpu().numpy()
        rgb = ((1.0 - np.clip(n, -1, 1)) * 0.5 * 255).astype(np.uint8)
        write_png(os.path.join(od, f"{i + 1:04d}.png"),
                  resize_nearest(rgb, png_size(p)))
    log.info("wrote %d normal keyframes to %s", len(paths), od)
    return out


def load_checkpoint(path: str, cfg=None,
                    device: torch.device | str | None = None):
    """A VGGT from a state_dict file in facebook/VGGT-1B's keys."""
    from .pose_estimation import load_vggt
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return load_vggt(sd, cfg, device)


def main(argv=None) -> int:
    from .models.vggt import VGGTConfig
    logging.basicConfig(level=logging.INFO)
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--base_path", required=True)
    p.add_argument("--vggt_checkpoint", required=True,
                   help="state_dict of facebook/VGGT-1B (torch.save)")
    p.add_argument("--config", default="{}",
                   help="JSON object of VGGTConfig fields to override")
    p.add_argument("--device", default=None,
                   help="torch device (default: the first CUDA card)")
    args = p.parse_args(argv)
    cfg = dataclasses.replace(VGGTConfig(), **{
        k: tuple(v) if isinstance(v, list) else v
        for k, v in json.loads(args.config).items()})
    generate_normals(args.base_path, load_checkpoint(
        args.vggt_checkpoint, cfg, args.device), device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
