"""Colormaps for depth and feature visualisation, copied from the JAX
``utils/colormaps.py`` (numpy): ``turbo`` for scalar maps, ``normalize``,
and ``apply_colormap``, which sends multi-channel maps to the PCA
colormap of ``train/render_mode.pca_colormap``."""
from __future__ import annotations

import numpy as np

# 16-knot approximation of the Turbo colormap, linearly interpolated
_TURBO_KNOTS = np.array([
    [0.190, 0.072, 0.232], [0.276, 0.181, 0.660], [0.324, 0.304, 0.925],
    [0.320, 0.444, 0.996], [0.250, 0.590, 0.905], [0.158, 0.730, 0.716],
    [0.099, 0.840, 0.523], [0.153, 0.920, 0.337], [0.332, 0.972, 0.195],
    [0.551, 0.992, 0.120], [0.742, 0.957, 0.135], [0.886, 0.862, 0.170],
    [0.975, 0.721, 0.161], [0.993, 0.537, 0.117], [0.937, 0.335, 0.069],
    [0.480, 0.016, 0.011]], np.float32)


def turbo(x: np.ndarray) -> np.ndarray:
    """[...] scalars in [0,1] -> [..., 3] turbo RGB."""
    x = np.clip(np.asarray(x, np.float32), 0.0, 1.0)
    pos = x * (len(_TURBO_KNOTS) - 1)
    lo = np.floor(pos).astype(int)
    hi = np.minimum(lo + 1, len(_TURBO_KNOTS) - 1)
    f = (pos - lo)[..., None]
    return (1 - f) * _TURBO_KNOTS[lo] + f * _TURBO_KNOTS[hi]


def normalize(x: np.ndarray, lo=None, hi=None) -> np.ndarray:
    lo = np.min(x) if lo is None else lo
    hi = np.max(x) if hi is None else hi
    return (x - lo) / max(hi - lo, 1e-12)


def apply_colormap(x: np.ndarray, kind: str = "turbo") -> np.ndarray:
    """Scalar map [...] -> turbo; feature map [C,...] with C > 1 -> PCA."""
    if x.ndim >= 3 and x.shape[0] > 1:
        from ..train.render_mode import pca_colormap
        return pca_colormap(x).transpose(1, 2, 0)
    return turbo(normalize(np.squeeze(x)))
