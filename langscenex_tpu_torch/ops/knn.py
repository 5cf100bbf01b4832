"""Mean 3-nearest-neighbour squared distance for splat scale
initialisation, port of the JAX ``ops/knn.py``.

Not simple-knn's distCUDA2: the JAX package morton-sorts the points and
scans a fixed +-window over the sorted order in several passes (shifted
quantisation origins and permuted axis interleaves) and merges the
candidates; the port does the same, so scale initialisation matches the
JAX package and not the reference CUDA extension.
"""
from __future__ import annotations

import torch

# (cell shift, axis interleave permutation) per pass
_PASSES = ((0.0, (0, 1, 2)), (0.5, (0, 1, 2)), (0.0, (2, 0, 1)),
           (0.5, (1, 2, 0)))


def _expand_bits10(v: torch.Tensor) -> torch.Tensor:
    """Spread the low 10 bits of v (int64 holding uint32 values) with two
    zero bits between each, wrapping at 32 bits like uint32."""
    m = 0xFFFFFFFF
    v = (v * 0x00010001) & m & 0xFF0000FF
    v = (v * 0x00000101) & m & 0x0F00F00F
    v = (v * 0x00000011) & m & 0xC30C30C3
    v = (v * 0x00000005) & m & 0x49249249
    return v


def morton_codes(points: torch.Tensor, shift: float = 0.0,
                 perm: tuple = (0, 1, 2)) -> torch.Tensor:
    """[P,3] -> [P] int64 30-bit morton codes over the bounding box."""
    lo = points.min(0).values
    hi = points.max(0).values
    q = torch.clamp((points - lo) / torch.clamp(hi - lo, min=1e-12) * 1023.0
                    + shift, 0, 1023)
    q = q.to(torch.int64)
    return (_expand_bits10(q[:, perm[0]])
            | (_expand_bits10(q[:, perm[1]]) << 1)
            | (_expand_bits10(q[:, perm[2]]) << 2))


def _topk_small(d: torch.Tensor, k: int):
    """k smallest per row, ties to the lower column (``lax.top_k`` of -d):
    a stable ascending sort."""
    s = torch.sort(d, dim=-1, stable=True)
    return s.values[..., :k], s.indices[..., :k]


def _window_top3(points: torch.Tensor, codes: torch.Tensor, window: int):
    """3 smallest squared neighbour distances per point (with neighbour
    ids) over a +-window of the morton-sorted order, in input order."""
    P = points.shape[0]
    dev = points.device
    order = torch.sort(codes, stable=True).indices
    sorted_pts = points[order]
    offs = torch.cat([torch.arange(-window, 0, device=dev),
                      torch.arange(1, window + 1, device=dev)])
    idx = torch.arange(P, device=dev)[:, None] + offs[None, :]
    valid = (idx >= 0) & (idx < P)
    idx = torch.clamp(idx, 0, P - 1)
    nbrs = sorted_pts[idx]                              # [P, 2W, 3]
    d2 = ((nbrs - sorted_pts[:, None]) ** 2).sum(-1)
    d2 = torch.where(valid, d2, torch.full_like(d2, float("inf")))
    top3, pos = _topk_small(d2, 3)
    nbr_ids = torch.gather(order[idx], 1, pos)
    out_d = torch.zeros((P, 3), dtype=points.dtype, device=dev)
    out_i = torch.zeros((P, 3), dtype=torch.int64, device=dev)
    out_d[order] = top3
    out_i[order] = nbr_ids
    return out_d, out_i


@torch.no_grad()
def mean_dist3_sq(points: torch.Tensor, window: int = 16,
                  num_passes: int = 4) -> torch.Tensor:
    """[P,3] -> [P] mean of squared distances to (approximately) the 3
    nearest neighbours: multi-pass morton-window scan, min-merged."""
    cand_d, cand_i = [], []
    for shift, perm in _PASSES[:num_passes]:
        d, i = _window_top3(points, morton_codes(points, shift, perm),
                            window)
        cand_d.append(d)
        cand_i.append(i)
    alld = torch.cat(cand_d, -1)                        # [P, 3*passes]
    alli = torch.cat(cand_i, -1)
    # sort candidates by distance, then drop duplicate neighbour ids
    srt = torch.sort(alld, dim=-1, stable=True).indices
    alld = torch.gather(alld, -1, srt)
    alli = torch.gather(alli, -1, srt)
    C = alld.shape[-1]
    dup = torch.zeros_like(alld, dtype=torch.bool)
    for j in range(1, C):
        dup[:, j] = (alli[:, :j] == alli[:, j:j + 1]).any(-1)
    alld = torch.where(dup, torch.full_like(alld, float("inf")), alld)
    top3 = _topk_small(alld, 3)[0]
    return torch.where(torch.isfinite(top3), top3, 0.0).mean(-1)
