"""Carry state across from the JAX package, as numpy arrays.

``gaussian_state_from_numpy`` takes the JAX ``GaussianState`` fields
(``np.asarray`` of each leaf) and builds the port's ``GaussianState`` on a
device; ``raster_camera_from_numpy`` does the same for a ``RasterCamera``
and ``train_state_from_numpy`` for a training ``TrainState`` (splats,
poses, exposure table, the three Adam states and the densify
statistics). PLY files need no converter: each package's ``load_ply``
reads the other's ``save_ply``.
"""
from __future__ import annotations

import numpy as np
import torch

from .ops.projection import RasterCamera
from .scene.gaussians import DensifyStats, GaussianState
from .train.field import TrainState
from .train.optim import AdamState

GAUSSIAN_FIELDS = ("xyz", "knn_f", "features_dc", "features_rest", "scaling",
                   "rotation", "opacity", "language_feature",
                   "instance_feature", "alive")


def gaussian_state_from_numpy(d: dict, device: torch.device | str = "cpu"
                              ) -> GaussianState:
    missing = [k for k in GAUSSIAN_FIELDS if k not in d]
    if missing:
        raise KeyError(f"missing GaussianState fields: {missing}")
    out = {}
    for k in GAUSSIAN_FIELDS:
        a = np.asarray(d[k])
        a = a.astype(bool) if k == "alive" else a.astype(np.float32)
        out[k] = torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return GaussianState(**out)


def raster_camera_from_numpy(w2c: np.ndarray, proj: np.ndarray, width: int,
                             height: int, tan_fovx: float, tan_fovy: float,
                             device: torch.device | str = "cpu"
                             ) -> RasterCamera:
    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32).copy()).to(device)
    return RasterCamera(w2c=t(w2c), proj=t(proj), width=int(width),
                        height=int(height), tan_fovx=float(tan_fovx),
                        tan_fovy=float(tan_fovy))


def _f32(a, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(a, np.float32))).to(device)


def train_state_from_numpy(d: dict, device: torch.device | str = "cpu"
                           ) -> TrainState:
    """Build a ``TrainState`` from numpy leaves::

        {"splats": {GaussianState fields}, "poses": [N,7], "app_ab": [N,2],
         "splat_opt": {"count": int, "mu": {group: arr}, "nu": {...}},
         "pose_opt": {"count": int, "mu": [N,7], "nu": [N,7]},
         "app_opt": {"count": int, "mu": [N,2], "nu": [N,2]},
         "stats": {DensifyStats fields}, "step": int}

    i.e. the optax ``ScaleByAdamState`` (count, mu, nu) of each optimizer,
    per group for the splat optimizer."""
    def adam(o, name=None):
        def leaves(x):
            if name is not None:
                return {name: _f32(x, device)}
            return {k: _f32(v, device) for k, v in x.items()}
        return AdamState(count=int(o["count"]), mu=leaves(o["mu"]),
                         nu=leaves(o["nu"]))
    return TrainState(
        splats=gaussian_state_from_numpy(d["splats"], device),
        poses=_f32(d["poses"], device), app_ab=_f32(d["app_ab"], device),
        splat_opt=adam(d["splat_opt"]),
        pose_opt=adam(d["pose_opt"], "poses"),
        app_opt=adam(d["app_opt"], "app_ab"),
        stats=DensifyStats(**{k: _f32(v, device)
                              for k, v in d["stats"].items()}),
        step=int(d["step"]))
