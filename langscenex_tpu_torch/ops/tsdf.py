"""TSDF fusion and mesh extraction, port of the JAX ``ops/tsdf.py``
(which stands in for the reference's open3d ScalableTSDFVolume,
gaussian_field.py:616-626, 707-740).

``create_volume`` and ``integrate`` are tensor code on the volume's
device: one projective, truncated SDF pass per view over the dense voxel
grid (``torch.round`` rounds half to even, as ``jnp.round`` does).
``extract_mesh`` (marching tetrahedra) and ``post_process_mesh`` run on
the host in numpy. The JAX package walks the sign-change cells in a
Python loop with a dict as its edge cache and clusters triangles with a
Python union-find; here both are vectorised and give the same mesh:

- every (cell, tetrahedron) with a sign change is classed by which of its
  four corners are inside (16 cases, tabled once), its edge crossings are
  listed in the loop's call order, and a vertex is numbered by the first
  crossing of its lattice edge, so vertices, colours and faces come out
  in the loop's order;
- triangles that share an edge are joined to the edge's first triangle
  and clustered with ``scipy.sparse.csgraph.connected_components``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..utils.device import resolve_device


@dataclasses.dataclass
class TSDFVolume:
    origin: np.ndarray          # [3] world min corner
    voxel_size: float
    dims: Tuple[int, int, int]
    tsdf: torch.Tensor          # [X,Y,Z] in [-1,1]
    weight: torch.Tensor        # [X,Y,Z]
    color: torch.Tensor         # [X,Y,Z,C]


def create_volume(origin, voxel_size: float, dims, channels: int = 3,
                  device: torch.device | str | None = None) -> TSDFVolume:
    device = resolve_device(device)
    X, Y, Z = dims
    return TSDFVolume(
        origin=np.asarray(origin, np.float32), voxel_size=voxel_size,
        dims=tuple(dims),
        tsdf=torch.ones((X, Y, Z), dtype=torch.float32, device=device),
        weight=torch.zeros((X, Y, Z), dtype=torch.float32, device=device),
        color=torch.zeros((X, Y, Z, channels), dtype=torch.float32,
                          device=device))


def integrate(vol: TSDFVolume, depth: torch.Tensor, K, w2c,
              color: Optional[torch.Tensor] = None, trunc: float = 0.04,
              depth_max: float = 20.0) -> TSDFVolume:
    """Integrate one view: depth [H,W], K [3,3], w2c [4,4], color [C,H,W]
    (optional), all moved to the volume's device."""
    dev = vol.tsdf.device

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32) if not
                               torch.is_tensor(a) else a,
                               dtype=torch.float32, device=dev)
    depth, K, w2c = t(depth), t(K), t(w2c)
    X, Y, Z = vol.dims
    H, W = depth.shape
    gx, gy, gz = torch.meshgrid(
        *(torch.arange(n, dtype=torch.float32, device=dev)
          for n in (X, Y, Z)), indexing="ij")
    pts = torch.stack([gx, gy, gz], -1) * vol.voxel_size + torch.as_tensor(
        vol.origin, device=dev)
    cam = pts @ w2c[:3, :3].T + w2c[:3, 3]
    z = cam[..., 2]
    u = cam[..., 0] / torch.clamp(z, min=1e-6) * K[0, 0] + K[0, 2]
    v = cam[..., 1] / torch.clamp(z, min=1e-6) * K[1, 1] + K[1, 2]
    # clamp before the integer cast: outside [0, W) the mask drops the
    # sample, and a far-off float has no int32 value
    ui = torch.round(u).clamp(-1, W).to(torch.int64).clamp(0, W - 1)
    vi = torch.round(v).clamp(-1, H).to(torch.int64).clamp(0, H - 1)
    in_view = (z > 0.05) & (u >= 0) & (u < W) & (v >= 0) & (v < H)
    d = depth[vi, ui]
    valid = in_view & (d > 0) & (d < depth_max)
    sdf = (d - z) / trunc
    valid = valid & (sdf > -1.0)
    sdf = torch.clamp(sdf, -1.0, 1.0)
    w_new = valid.to(torch.float32)
    w_tot = vol.weight + w_new
    tsdf = torch.where(
        w_tot > 0, (vol.tsdf * vol.weight + sdf * w_new)
        / torch.clamp(w_tot, min=1e-6), vol.tsdf)
    new_color = vol.color
    if color is not None:
        cvals = t(color)[:, vi, ui].permute(1, 2, 3, 0)      # [X,Y,Z,C]
        new_color = torch.where(
            w_tot[..., None] > 0,
            (vol.color * vol.weight[..., None] + cvals * w_new[..., None])
            / torch.clamp(w_tot[..., None], min=1e-6), vol.color)
    return dataclasses.replace(vol, tsdf=tsdf, weight=w_tot, color=new_color)


# six tetrahedra decomposition of a cube (corner indices)
_TETS = np.array([[0, 5, 1, 6], [0, 1, 2, 6], [0, 2, 3, 6],
                  [0, 3, 7, 6], [0, 7, 4, 6], [0, 4, 5, 6]])
_CORNERS = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
                     [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1]])


def _case_tables():
    """Per inside-corner bitmask of a tetrahedron (16 cases): its edge
    crossings as (inside corner, outside corner) in the JAX loop's call
    order, [16,4,2], their count, and its faces as indices into those
    crossings, [16,2,3], with their count."""
    calls = np.zeros((16, 4, 2), np.int64)
    faces = np.zeros((16, 2, 3), np.int64)
    n_calls = np.zeros(16, np.int64)
    n_faces = np.zeros(16, np.int64)
    for code in range(16):
        ins = [i for i in range(4) if code >> i & 1]
        outs = [i for i in range(4) if not code >> i & 1]
        if len(ins) == 1:
            c, f = [(ins[0], o) for o in outs], [(0, 1, 2)]
        elif len(ins) == 3:
            c, f = [(i, outs[0]) for i in ins], [(2, 1, 0)]
        elif len(ins) == 2:
            (a, b), (cc, d) = ins, outs
            c, f = [(a, cc), (a, d), (b, cc), (b, d)], [(0, 1, 3), (0, 3, 2)]
        else:
            continue
        calls[code, :len(c)] = c
        faces[code, :len(f)] = f
        n_calls[code], n_faces[code] = len(c), len(f)
    return calls, n_calls, faces, n_faces


_CALLS, _N_CALLS, _FACES, _N_FACES = _case_tables()


def extract_mesh(vol: TSDFVolume, min_weight: float = 1.0):
    """Marching tetrahedra over the TSDF zero crossing. Returns (vertices
    [V,3] world f32, faces [F,3] int32, vertex colours [V,C] f32), equal
    to the JAX package's loop."""
    tsdf = vol.tsdf.detach().cpu().numpy()
    weight = vol.weight.detach().cpu().numpy()
    colors = vol.color.detach().cpu().numpy()
    tsdf = np.where(weight >= min_weight, tsdf, np.nan)
    X, Y, Z = vol.dims
    C = colors.shape[-1]
    empty = (np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32),
             np.zeros((0, C), np.float32))

    # cells with a sign change and eight finite corners
    sgn = tsdf < 0
    f = np.isfinite(tsdf)
    base = sgn[:-1, :-1, :-1]
    cells = np.zeros((X - 1, Y - 1, Z - 1), bool)
    finite = np.ones_like(cells)
    for dx, dy, dz in _CORNERS:
        sl = (slice(dx, X - 1 + dx), slice(dy, Y - 1 + dy),
              slice(dz, Z - 1 + dz))
        cells |= sgn[sl] != base
        finite &= f[sl]
    cell = np.stack(np.nonzero(cells & finite), -1)          # [M,3], C order
    if not len(cell):
        return empty

    corner = cell[:, None, :] + _CORNERS[None]               # [M,8,3]
    lin = (corner[..., 0] * Y + corner[..., 1]) * Z + corner[..., 2]
    flat = tsdf.reshape(-1)
    tet_lin = lin[:, _TETS].reshape(-1, 4)                   # [M*6,4]
    code = ((flat[tet_lin] < 0) << np.arange(4)).sum(-1)
    act = np.nonzero(_N_CALLS[code])[0]                      # (cell, tet) order
    if not len(act):
        return empty
    tet_lin, code = tet_lin[act], code[act]

    # edge crossings in call order; a vertex per lattice edge, numbered by
    # its first crossing
    calls = _CALLS[code]                                     # [K,4,2]
    p_in = np.take_along_axis(tet_lin, calls[..., 0], 1)     # [K,4]
    p_out = np.take_along_axis(tet_lin, calls[..., 1], 1)
    used = np.arange(4) < _N_CALLS[code][:, None]
    p_in, p_out = p_in[used], p_out[used]
    n_vox = X * Y * Z
    key = np.minimum(p_in, p_out) * n_vox + np.maximum(p_in, p_out)
    _, first, inv = np.unique(key, return_index=True, return_inverse=True)
    order = np.argsort(first)
    rank = np.empty_like(order)
    rank[order] = np.arange(len(order))
    slot_vid = np.zeros(used.shape, np.int64)
    slot_vid[used] = rank[inv.reshape(-1)]

    a, b = p_in[first[order]], p_out[first[order]]
    v0, v1 = flat[a], flat[b]
    t = v0 / (v0 - v1)
    pos0 = np.stack(np.unravel_index(a, (X, Y, Z)), -1)
    pos1 = np.stack(np.unravel_index(b, (X, Y, Z)), -1)
    pos = (1 - t)[:, None] * pos0 + t[:, None] * pos1        # f64, as JAX's
    cflat = colors.reshape(-1, C)
    cols = (1 - t)[:, None] * cflat[a] + t[:, None] * cflat[b]

    fv = np.take_along_axis(slot_vid[:, None, :],
                            _FACES[code].reshape(len(code), -1)[:, None, :],
                            2).reshape(len(code), 2, 3)
    faces = fv[np.arange(2) < _N_FACES[code][:, None]]
    V = pos.astype(np.float32) * vol.voxel_size + vol.origin
    return (V, faces.astype(np.int32), cols.astype(np.float32))


def post_process_mesh(verts: np.ndarray, faces: np.ndarray,
                      colors: Optional[np.ndarray] = None,
                      cluster_to_keep: int = 3):
    """Drop floaters and disconnected parts (gaussian_field.py:43-63):
    cluster triangles connected through shared edges (o3d's
    ``cluster_connected_triangles``), keep clusters with at least as many
    triangles as the ``cluster_to_keep``-th largest (floored at 50), then
    drop degenerate triangles and unreferenced vertices. ``colors=None``
    passes through."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components

    F = len(faces)
    if F == 0:
        return verts, faces, colors
    e = np.stack([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]],
                 1).reshape(-1, 2).astype(np.int64)
    n = int(faces.max()) + 1
    key = e.min(1) * n + e.max(1)
    tri = np.repeat(np.arange(F), 3)
    srt = np.argsort(key, kind="stable")        # each edge's first triangle
    k = key[srt]
    head = np.r_[True, k[1:] != k[:-1]]
    owner = tri[srt][np.maximum.accumulate(np.where(head, np.arange(len(k)),
                                                    0))]
    graph = coo_matrix((np.ones(len(k), np.int8), (owner, tri[srt])),
                       shape=(F, F))
    _, labels = connected_components(graph, directed=False)
    counts = np.bincount(labels)
    sizes = np.sort(counts)
    thresh = max(int(sizes[-min(cluster_to_keep, len(sizes))]), 50)
    faces = faces[counts[labels] >= thresh]
    nondeg = ((faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2])
              & (faces[:, 0] != faces[:, 2]))
    faces = faces[nondeg]
    used = np.unique(faces)
    remap = np.full(len(verts), -1, np.int64)
    remap[used] = np.arange(len(used))
    verts = verts[used]
    faces = remap[faces].astype(faces.dtype)
    if colors is not None:
        colors = colors[used]
    return verts, faces, colors


def save_mesh_ply(path: str, verts: np.ndarray, faces: np.ndarray,
                  colors: Optional[np.ndarray] = None) -> None:
    with open(path, "wb") as f:
        hdr = ["ply", "format binary_little_endian 1.0",
               f"element vertex {len(verts)}",
               "property float x", "property float y", "property float z"]
        if colors is not None:
            hdr += ["property uchar red", "property uchar green",
                    "property uchar blue"]
        hdr += [f"element face {len(faces)}",
                "property list uchar int vertex_indices", "end_header"]
        f.write(("\n".join(hdr) + "\n").encode())
        if colors is not None:
            dt = np.dtype([("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
                           ("r", "u1"), ("g", "u1"), ("b", "u1")])
            rec = np.empty(len(verts), dt)
            rec["x"], rec["y"], rec["z"] = verts.T
            c = (np.clip(colors[:, :3], 0, 1) * 255).astype(np.uint8)
            rec["r"], rec["g"], rec["b"] = c.T
            f.write(rec.tobytes())
        else:
            f.write(verts.astype("<f4").tobytes())
        fd = np.empty(len(faces), np.dtype([("n", "u1"), ("v", "<i4", 3)]))
        fd["n"] = 3
        fd["v"] = faces
        f.write(fd.tobytes())
