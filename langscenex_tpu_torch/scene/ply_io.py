"""PLY save/load for Gaussian splat scenes, port of the JAX
``scene/ply_io.py``: binary little-endian with the reference's attribute
layout (gaussian_model.py:400-504) — x y z nx ny nz f_dc_* f_rest_*
opacity scale_* rot_* [language_feature_* instance_feature_*], f_dc and
f_rest stored channel-major. Files written by either package load in the
other.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from ..utils.device import resolve_device
from .gaussians import GaussianState, _round_capacity


def attribute_names(sh_rest: int, include_feature: bool) -> list[str]:
    names = ['x', 'y', 'z', 'nx', 'ny', 'nz']
    names += [f'f_dc_{i}' for i in range(3)]
    names += [f'f_rest_{i}' for i in range(sh_rest * 3)]
    names.append('opacity')
    names += [f'scale_{i}' for i in range(3)]
    names += [f'rot_{i}' for i in range(4)]
    if include_feature:
        names += [f'language_feature_{i}' for i in range(3)]
        names += [f'instance_feature_{i}' for i in range(3)]
    return names


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def save_ply(state: GaussianState, path: str,
             include_feature: bool = True) -> None:
    alive = _np(state.alive).astype(bool)
    xyz = _np(state.xyz)[alive]
    n = xyz.shape[0]
    normals = np.zeros_like(xyz)
    # channel-major flatten: [N, R, 3] -> [N, 3, R] -> [N, 3R]
    f_dc = _np(state.features_dc)[alive].transpose(0, 2, 1).reshape(n, -1)
    f_rest = _np(state.features_rest)[alive].transpose(0, 2, 1).reshape(n, -1)
    cols = [xyz, normals, f_dc, f_rest, _np(state.opacity)[alive],
            _np(state.scaling)[alive], _np(state.rotation)[alive]]
    if include_feature:
        cols += [_np(state.language_feature)[alive],
                 _np(state.instance_feature)[alive]]
    data = np.concatenate(cols, axis=1).astype('<f4')
    names = attribute_names(state.features_rest.shape[1], include_feature)
    if data.shape[1] != len(names):
        raise ValueError(f"{data.shape[1]} columns for {len(names)} names")

    os.makedirs(os.path.dirname(path) or '.', exist_ok=True)
    with open(path, 'wb') as f:
        header = ['ply', 'format binary_little_endian 1.0',
                  f'element vertex {n}']
        header += [f'property float {nm}' for nm in names]
        header.append('end_header')
        f.write(('\n'.join(header) + '\n').encode('ascii'))
        f.write(data.tobytes())


def _read_ply_vertex(path: str):
    with open(path, 'rb') as f:
        header_lines = []
        while True:
            line = f.readline().decode('ascii').strip()
            header_lines.append(line)
            if line == 'end_header':
                break
        fmt = next(l for l in header_lines if l.startswith('format'))
        if 'binary_little_endian' not in fmt:
            raise ValueError(f"unsupported ply format: {fmt}")
        n = int(next(l for l in header_lines
                     if l.startswith('element vertex')).split()[-1])
        props = [l.split()[2] for l in header_lines
                 if l.startswith('property float')]
        raw = np.frombuffer(f.read(n * len(props) * 4), dtype='<f4')
    return {nm: raw.reshape(n, len(props))[:, i].copy()
            for i, nm in enumerate(props)}, n


def load_ply(path: str, max_sh_degree: int = 3,
             capacity: Optional[int] = None,
             device: torch.device | str | None = None) -> GaussianState:
    """Load a splat PLY into a capacity-padded GaussianState on
    ``device``. Missing language/instance channels load as zeros."""
    device = resolve_device(device)
    d, n = _read_ply_vertex(path)
    cap = capacity or _round_capacity(int(n * 1.5))
    R = (max_sh_degree + 1) ** 2 - 1

    def col(prefix, k):
        cols = sorted([nm for nm in d if nm.startswith(prefix)
                       and nm[len(prefix):].isdigit()],
                      key=lambda s: int(s[len(prefix):]))
        if len(cols) != k:
            raise ValueError(f"{prefix}: expected {k} got {len(cols)}")
        return np.stack([d[c] for c in cols], -1)

    xyz = np.stack([d['x'], d['y'], d['z']], -1)
    f_dc = col('f_dc_', 3).reshape(n, 3, 1).transpose(0, 2, 1)
    f_rest = col('f_rest_', 3 * R).reshape(n, 3, R).transpose(0, 2, 1)
    opacity = d['opacity'][:, None]
    scaling = col('scale_', 3)
    rotation = col('rot_', 4)
    has_feat = any(nm.startswith('language_feature_') for nm in d)
    lang = col('language_feature_', 3) if has_feat else np.zeros((n, 3))
    inst = col('instance_feature_', 3) if has_feat else np.zeros((n, 3))

    def pad(a, fill=0.0):
        out = np.full((cap,) + a.shape[1:], fill, np.float32)
        out[:n] = a
        return torch.from_numpy(out).to(device)

    rot_pad = np.zeros((cap, 4), np.float32)
    rot_pad[:, 0] = 1.0
    rot_pad[:n] = rotation
    alive = np.zeros(cap, bool)
    alive[:n] = True
    return GaussianState(
        xyz=pad(xyz), knn_f=pad(np.zeros((n, 6))), features_dc=pad(f_dc),
        features_rest=pad(f_rest), scaling=pad(scaling),
        rotation=torch.from_numpy(rot_pad).to(device), opacity=pad(opacity),
        language_feature=pad(lang), instance_feature=pad(inst),
        alive=torch.from_numpy(alive).to(device))
