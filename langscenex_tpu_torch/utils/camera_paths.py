"""Camera paths, port of ``post_pose_process`` from the JAX
``utils/camera_paths.py`` (pose_utils.post_pose_process:574-585): the
optimised [N,7] world-to-camera quat + t poses written as per-view
camera-to-world ``render_camera/%04d.npz`` files with the intrinsics of an
example camera file. The render paths (ellipse, spiral, interpolation)
and the virtual-camera jitter are not ported yet."""
from __future__ import annotations

import os

import numpy as np
import torch

from ..ops.quat import camera_from_tensor


def post_pose_process(pose_qt, example_npz: str, out_dir: str) -> None:
    os.makedirs(out_dir, exist_ok=True)
    K = np.load(example_npz)["intrinsics"]
    w2c = camera_from_tensor(torch.from_numpy(
        np.array(pose_qt, np.float32))).numpy()
    for i, m in enumerate(w2c):
        np.savez(os.path.join(out_dir, f"{i + 1:04d}.npz"),
                 pose=np.linalg.inv(m), intrinsics=K)
