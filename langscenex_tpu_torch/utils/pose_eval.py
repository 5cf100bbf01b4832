"""Camera trajectory evaluation: SIM3/SE3 alignment, ATE, RPE.

The port's own copy of the JAX package's ``utils/pose_eval.py`` (numpy
only; the reference's utils/utils_poses/: ATE/compute_ATE, comp_ate.py:81,
align_traj.py's SIM3 alignment by Umeyama), the standalone toolkit that
scores optimised trajectories against ground truth.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def umeyama(src: np.ndarray, dst: np.ndarray, with_scale: bool = True):
    """Least-squares similarity transform src -> dst (Umeyama 1991).
    Returns (s, R, t) with dst ~ s * R @ src + t."""
    mu_s = src.mean(0)
    mu_d = dst.mean(0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    var_s = (xs ** 2).sum() / len(src)
    s = float(np.trace(np.diag(D) @ S) / var_s) if with_scale else 1.0
    t = mu_d - s * R @ mu_s
    return s, R, t


def align_trajectory(est: np.ndarray, gt: np.ndarray,
                     with_scale: bool = True) -> np.ndarray:
    """Estimated camera centres [N,3] aligned to gt (SIM3)."""
    s, R, t = umeyama(est, gt, with_scale)
    return (s * (R @ est.T)).T + t


def ate_rmse(est_centers: np.ndarray, gt_centers: np.ndarray,
             align: bool = True) -> float:
    """Absolute trajectory error RMSE after an optional SIM3 alignment."""
    est = align_trajectory(est_centers, gt_centers) if align else est_centers
    err = np.linalg.norm(est - gt_centers, axis=-1)
    return float(np.sqrt((err ** 2).mean()))


def rpe(est_poses: np.ndarray, gt_poses: np.ndarray,
        delta: int = 1) -> Tuple[float, float]:
    """Relative pose error (translation RMSE, rotation RMSE in degrees)
    over the pose pairs (i, i + delta). Poses are [N,4,4] c2w."""
    def rel(poses):
        return [np.linalg.inv(poses[i]) @ poses[i + delta]
                for i in range(len(poses) - delta)]
    terrs, rerrs = [], []
    for e, g in zip(rel(est_poses), rel(gt_poses)):
        d = np.linalg.inv(g) @ e
        terrs.append(np.linalg.norm(d[:3, 3]))
        cos = (np.trace(d[:3, :3]) - 1) / 2
        rerrs.append(np.degrees(np.arccos(np.clip(cos, -1, 1))))
    return (float(np.sqrt(np.mean(np.square(terrs)))),
            float(np.sqrt(np.mean(np.square(rerrs)))))
