"""Novel-view camera paths and pose post-processing, port of the JAX
package's ``utils/camera_paths.py`` (field_construction/utils/
pose_utils.py: the ellipse, spiral and interpolated render paths,
:305-571, and post_pose_process, :574-585; the virtual-camera jitter
gen_virtul_cam, utils/camera_utils.py:86).

The paths are numpy [n,4,4] world-to-camera matrices. The ellipse's
constant-velocity resampling goes through the port's
``stepfun.sample`` on float32 tensors, as the JAX package's goes through
its own on float32 arrays. :func:`gen_virtual_cam` draws from an explicit
``np.random.Generator``. :func:`post_pose_process` writes the optimised
[N,7] world-to-camera quat + t poses as per-view camera-to-world
``render_camera/%04d.npz`` files with the intrinsics of an example camera
file.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from ..ops.quat import camera_from_tensor


def _look_at(center: np.ndarray, target: np.ndarray, up: np.ndarray):
    """The w2c matrix of a camera at ``center`` whose +z looks at
    ``target`` (rows: right, down, forward)."""
    fwd = target - center
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(fwd, up)
    right = right / np.linalg.norm(right)
    down = np.cross(fwd, right)
    R = np.stack([right, down, fwd], 0)      # w2c rows
    w2c = np.eye(4)
    w2c[:3, :3] = R
    w2c[:3, 3] = -R @ center
    return w2c


def _constant_velocity_thetas(positions_of, n_frames: int) -> np.ndarray:
    """Reparameterise a closed path so that frames move at about constant
    speed: sample the path densely, histogram the segment lengths over
    theta and inverse-CDF resample theta (pose_utils.py:343-345 /
    :561-564, the reference's only live use of stepfun.sample)."""
    from .stepfun import sample
    theta = np.linspace(0, 2 * np.pi, 4 * n_frames + 1)
    lengths = np.linalg.norm(np.diff(positions_of(theta), axis=0), axis=-1)
    t = torch.from_numpy(theta).float()
    w_logits = torch.log(torch.from_numpy(lengths).float() + 1e-12)
    return sample(None, t, w_logits, n_frames + 1).numpy()[:-1]


def ellipse_path(centers: np.ndarray, n_frames: int = 120,
                 z_rate: float = 0.0,
                 const_speed: bool = True) -> np.ndarray:
    """An elliptical orbit through the training cameras' centroid
    (generate_ellipse_path, with the constant-velocity resampling).
    Returns [n,4,4] w2c."""
    target = centers.mean(0)
    offsets = centers - target
    a = np.percentile(np.abs(offsets[:, 0]), 90)
    b = np.percentile(np.abs(offsets[:, 1]), 90)
    z0 = offsets[:, 2].mean()
    up = np.array([0.0, -1.0, 0.0])

    def positions(theta):
        return target + np.stack([a * np.cos(theta), b * np.sin(theta),
                                  z0 + z_rate * np.sin(theta)], -1)

    if const_speed:
        thetas = _constant_velocity_thetas(positions, n_frames)
    else:
        thetas = 2 * np.pi * np.arange(n_frames) / n_frames
    return np.stack([_look_at(c, target, up) for c in positions(thetas)])


def spiral_path(centers: np.ndarray, n_frames: int = 120,
                n_rots: int = 2, zrate: float = 0.5) -> np.ndarray:
    """An LLFF-style spiral (generate_spiral_path). Returns [n,4,4] w2c."""
    target = centers.mean(0)
    rad = np.percentile(np.linalg.norm(centers - target, axis=-1), 90)
    up = np.array([0.0, -1.0, 0.0])
    poses = []
    for i in range(n_frames):
        th = 2 * np.pi * n_rots * i / n_frames
        c = target + rad * np.array([np.cos(th), np.sin(th),
                                     zrate * np.sin(th * 0.5)])
        poses.append(_look_at(c, target, up))
    return np.stack(poses)


def interpolate_path(w2c_a: np.ndarray, w2c_b: np.ndarray,
                     n_frames: int = 30) -> np.ndarray:
    """Linear c2w interpolation between two cameras, the rotation block
    re-orthonormalised (cameras.sample_cam:193-218 as a path)."""
    c2w_a = np.linalg.inv(w2c_a)
    c2w_b = np.linalg.inv(w2c_b)
    out = []
    for i in range(n_frames):
        w = i / max(n_frames - 1, 1)
        c2w = (1 - w) * c2w_a + w * c2w_b
        U, _, Vt = np.linalg.svd(c2w[:3, :3])
        c2w[:3, :3] = U @ Vt
        out.append(np.linalg.inv(c2w))
    return np.stack(out)


def gen_virtual_cam(w2c: np.ndarray, trans_noise: float = 1.5,
                    deg_noise: float = 30.0, rng=None) -> np.ndarray:
    """A noise-perturbed camera (camera_utils.gen_virtul_cam:86): three
    angles and a translation drawn from ``rng`` (a ``np.random.
    Generator``; a fresh one when None)."""
    rng = rng or np.random.default_rng()
    ang = np.radians(rng.uniform(-deg_noise, deg_noise, 3))
    cx, cy, cz = np.cos(ang)
    sx, sy, sz = np.sin(ang)
    Rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    Rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    out = w2c.copy()
    out[:3, :3] = Rz @ Ry @ Rx @ w2c[:3, :3]
    out[:3, 3] = w2c[:3, 3] + rng.uniform(-trans_noise, trans_noise, 3)
    return out


def post_pose_process(pose_qt, example_npz: str, out_dir: str) -> None:
    os.makedirs(out_dir, exist_ok=True)
    K = np.load(example_npz)["intrinsics"]
    w2c = camera_from_tensor(torch.from_numpy(
        np.array(pose_qt, np.float32))).numpy()
    for i, m in enumerate(w2c):
        np.savez(os.path.join(out_dir, f"{i + 1:04d}.npz"),
                 pose=np.linalg.inv(m), intrinsics=K)
