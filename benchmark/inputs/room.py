"""The field cells' inputs, made from the seed on the device: a room of
splats on four walls, the cameras of an arc inside it, and per-camera
language targets.

The room is a trained scene's shape at the reference's dense-init size:
points on four walls with a smooth relief, opacities 0.5-0.95, scales of
a few millimetres, random rotations, an RGB colour as the SH DC term with
small higher orders, and language and instance features. Slots past the
points up to the capacity are dead, as the trainer's fixed capacity
holds them. The targets stand for LSeg + VQ output: each camera's
language map is piecewise constant over a grid of segments at an eighth
of the image size (a seeded feature per segment, some segments masked
with id -1), which the trainer reads as files and resizes.

The driver hands these to the program and the reference makes them again
from the same seed; both sides see the same numbers.
"""
from __future__ import annotations

import math
import os

import numpy as np
import torch

SH_C0 = 0.28209479177387814


def generator(seed: int, device, stream: int) -> torch.Generator:
    """A generator on ``device`` for one named stream of the seed."""
    return torch.Generator(device=device).manual_seed(
        (int(seed) * 1_000_003 + stream) % (2 ** 63))


def rot_y(deg: float) -> np.ndarray:
    c, s = math.cos(math.radians(deg)), math.sin(math.radians(deg))
    return np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]])


# the keys of ``scene``: the trainer's splat groups and the alive mask
SCENE_KEYS = ("xyz", "knn_f", "features_dc", "features_rest", "scaling",
              "rotation", "opacity", "language_feature", "instance_feature",
              "alive")


def scene(cfg: dict, seed: int, device) -> dict:
    """The room's splats, in the trainer's raw parameter space (log
    scales, logit opacity, unnormalised wxyz rotation), capacity-padded."""
    n, cap = cfg["points"], cfg["capacity"]
    room = cfg["room"]
    g = generator(seed, device, 1)
    f32 = dict(dtype=torch.float32, device=device)

    def uni(shape, lo, hi):
        return torch.rand(shape, generator=g, **f32) * (hi - lo) + lo
    wall = torch.arange(n, device=device) % 4
    u = uni((n,), -room["wall"], room["wall"])
    v = uni((n,), -1.0, 1.0)
    depth = room["wall"] + room["relief"] * torch.sin(2.5 * u + wall) \
        * torch.cos(3.0 * v)
    R = torch.as_tensor(np.stack([rot_y(90.0 * k) for k in range(4)]),
                        **f32)[wall]
    means = (u[:, None] * R[:, :, 0] + v[:, None] * R[:, :, 1]
             + depth[:, None] * R[:, :, 2])
    cols = uni((n, 3), 0.0, 1.0)
    log_scales = uni((n, 3), room["log_scale_min"], room["log_scale_max"])
    quats = torch.randn((n, 4), generator=g, **f32)
    quats = quats / torch.linalg.norm(quats, dim=-1, keepdim=True)
    opac = uni((n,), room["opacity_min"], room["opacity_max"])
    n_rest = (cfg["sh_degree"] + 1) ** 2 - 1
    rest = room["sh_rest_std"] * torch.randn((n, n_rest, 3), generator=g,
                                             **f32)
    lang = uni((n, 3), -1.0, 1.0)
    inst = uni((n, 3), -1.0, 1.0)
    inst[:, 0] = (wall.float() - 1.5) / 2.0
    knn_f = torch.randn((n, 6), generator=g, **f32)

    def pad(x, fill=0.0):
        out = torch.full((cap,) + tuple(x.shape[1:]), fill, **f32)
        out[:n] = x
        return out
    rotation = pad(quats)
    rotation[n:, 0] = 1.0
    dead_opacity = math.log(0.1 / 0.9)
    alive = torch.zeros(cap, dtype=torch.bool, device=device)
    alive[:n] = True
    return dict(
        xyz=pad(means), knn_f=pad(knn_f),
        features_dc=pad(((cols - 0.5) / SH_C0)[:, None]),
        features_rest=pad(rest), scaling=pad(log_scales),
        rotation=rotation,
        opacity=pad(torch.log(opac / (1.0 - opac))[:, None], dead_opacity),
        language_feature=pad(lang), instance_feature=pad(inst), alive=alive)


def fovy(cfg: dict) -> float:
    focal = cfg["width"] / (2.0 * math.tan(cfg["fovx"] / 2.0))
    return 2.0 * math.atan(cfg["height"] / (2.0 * focal))


def arc_poses(cfg: dict) -> list:
    """(R cam-to-world, T world-to-cam) of each camera: views from near
    the room's centre panning ``arc`` degrees of yaw across a corner."""
    n, arc = cfg["cameras"], cfg["arc_degrees"]
    out = []
    for i in range(n):
        R = rot_y(arc * (i / max(n - 1, 1) - 0.5) + cfg["arc_centre_yaw"])
        centre = cfg["room"]["camera_offset"] * R[:, 2]
        out.append((R, -R.T @ centre))
    return out


def w2c(R: np.ndarray, T: np.ndarray) -> np.ndarray:
    """World-to-camera 4x4 from (R cam-to-world, T world-to-cam)."""
    m = np.eye(4)
    m[:3, :3] = R.T
    m[:3, 3] = T
    return m


def target_size(cfg: dict) -> tuple:
    d = cfg["targets"]["downsample"]
    return cfg["height"] // d, cfg["width"] // d


def targets(cfg: dict, seed: int, device) -> list:
    """Per camera (features [3, h, w] f32, segments [h, w] int32) at the
    targets' resolution, on the host."""
    t = cfg["targets"]
    h, w = target_size(cfg)
    b = t["segment_cells"]
    gy, gx = -(-h // b), -(-w // b)
    g = generator(seed, device, 2)
    out = []
    for _ in range(cfg["cameras"]):
        ids = torch.arange(gy * gx, device=device).reshape(gy, gx)
        masked = torch.rand((gy, gx), generator=g, device=device) \
            < t["masked_share"]
        ids = torch.where(masked, -1, ids)
        feats = torch.rand((gy * gx, 3), generator=g, device=device) * 2 - 1
        seg = ids.repeat_interleave(b, 0).repeat_interleave(b, 1)[:h, :w]
        f = feats[seg.clamp(min=0)].permute(2, 0, 1)
        out.append((f.float().cpu().numpy(), seg.int().cpu().numpy()))
    return out


def write_targets(cfg: dict, seed: int, device, lang_dir: str) -> None:
    """The targets as the trainer reads them: ``<name>_f.npy`` and
    ``<name>_s.npy`` per camera."""
    for i, (f, s) in enumerate(targets(cfg, seed, device)):
        name = image_name(i)
        np.save(os.path.join(lang_dir, name + "_f.npy"), f)
        np.save(os.path.join(lang_dir, name + "_s.npy"), s)


def image_name(i: int) -> str:
    return f"{i + 1:04d}"


def image(cfg: dict) -> np.ndarray:
    """One RGB image [3, H, W] in [0, 1] for every camera (the semantic
    phase takes no image loss)."""
    H, W = cfg["height"], cfg["width"]
    ys = np.linspace(0.2, 0.8, H, dtype=np.float32)[:, None]
    xs = np.linspace(0.3, 0.7, W, dtype=np.float32)[None, :]
    return np.stack([ys * xs * 2, np.broadcast_to(ys, (H, W)),
                     np.broadcast_to(xs, (H, W))]).astype(np.float32)


def resize_bilinear_chw(x: np.ndarray, H: int, W: int) -> np.ndarray:
    """[C, h, w] -> [C, H, W] bilinear, align_corners=False."""
    C, h, w = x.shape
    if (h, w) == (H, W):
        return x
    ys = (np.arange(H) + 0.5) * h / H - 0.5
    xs = (np.arange(W) + 0.5) * w / W - 0.5
    y0 = np.clip(np.floor(ys).astype(int), 0, h - 1)
    x0 = np.clip(np.floor(xs).astype(int), 0, w - 1)
    y1 = np.clip(y0 + 1, 0, h - 1)
    x1 = np.clip(x0 + 1, 0, w - 1)
    wy = np.clip(ys - y0, 0, 1)[None, :, None]
    wx = np.clip(xs - x0, 0, 1)[None, None, :]
    a = x[:, y0][:, :, x0]
    b = x[:, y0][:, :, x1]
    c = x[:, y1][:, :, x0]
    d = x[:, y1][:, :, x1]
    return (a * (1 - wy) * (1 - wx) + b * (1 - wy) * wx
            + c * wy * (1 - wx) + d * wy * wx).astype(np.float32)


def resize_nearest(x: np.ndarray, H: int, W: int) -> np.ndarray:
    h, w = x.shape
    if (h, w) == (H, W):
        return x
    ys = np.clip((np.arange(H) * h) // H, 0, h - 1)
    xs = np.clip((np.arange(W) * w) // W, 0, w - 1)
    return x[ys][:, xs]
