"""Tile binning: duplicate splats into (tile, depth)-sorted pair lists.

Port of the JAX ``ops/binning.py`` on its rank-key path. The enumeration
is the JAX package's broadcast layout, unchanged: tier 1 enumerates the
first K1 tiles of every splat on a [P, K1] grid, optional mid tiers
(``extra_tiers``) and the final catch-all tier enumerate further tile
slots for the splats with the most tiles, the exact per-tile conic cull
(:class:`CullSpec`) drops provably invisible pairs, and a ``max_pairs``
budget drops whole trailing splats by id (dropped pairs carry the tile
sentinel ``n_tiles`` and the sid sentinel ``P``). ``num_pairs``,
``overflowed``, ``k_overflowed`` and ``num_big`` keep their JAX meaning,
so adaptive pair-cap growth carries over.

Sorting differs in mechanism only. Valid pairs are first compacted to the
front of a ``min(max_pairs, A)``-slot stream (kernel K3,
:mod:`.compaction`) and then sorted by one packed int32 key
``tile << 22 | depth rank`` (kernel K4, :mod:`.sort_engine`, a stable
radix sort). ``compact`` and ``pallas_sort`` therefore select nothing
here: the JAX docstrings state that the lists are identical either way,
and this port always compacts and radix-sorts. When ``(n_tiles + 1) << 22``
would overflow int32, the (tile, depth) order comes from two stable
radix sorts instead (the JAX ``_finish`` fallback). ``key_only`` belongs
to a path that is not ported and raises ``NotImplementedError``.

When nothing overflows, ``(point_list, tile_starts, tile_counts)``,
``num_pairs``, ``overflowed``, ``k_overflowed`` and ``num_big`` equal the
JAX output bit for bit, given the same ``ProcessedSplats``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .compaction import compact_pairs, compact_pairs_plain
from .projection import ProcessedSplats
from .sort_engine import sort_pairs, sort_pairs_plain

I32_MAX = 2 ** 31 - 1


class CullSpec(NamedTuple):
    """Per-splat data for the exact per-tile conic cull: a (splat, tile)
    pair is dropped iff the minimum over the tile rectangle of
    Q(d) = a dx^2 + 2b dx dy + c dy^2 exceeds ``qmax`` = 2 ln(255 op)
    (+ f32 margin), i.e. iff no pixel of the tile passes alpha >= 1/255."""
    mean2d: torch.Tensor      # [P,2] pixel-space means
    conic: torch.Tensor       # [P,3] (a, b, c) inverse 2D covariance
    qmax: torch.Tensor        # [P] support threshold
    tile_w: int
    tile_h: int


class TileLists(NamedTuple):
    point_list: torch.Tensor   # [L] int32 splat ids in (tile, depth) order
    tile_starts: torch.Tensor  # [n_tiles] int32
    tile_counts: torch.Tensor  # [n_tiles] int32
    num_pairs: torch.Tensor    # [] int32 true demand, saturated at 2^31-1
    overflowed: torch.Tensor   # [] bool: demand > budget or k_overflowed
    k_overflowed: torch.Tensor  # [] bool: a tier register was exhausted
    num_big: torch.Tensor      # [] int32 splats exceeding K1 tiles


def _rect_qmin(a, b, c, lx, hx, ly, hy):
    """Exact min of Q over [lx,hx]x[ly,hy] for PSD conics (elementwise)."""
    a = torch.clamp(a, min=1e-12)
    c = torch.clamp(c, min=1e-12)
    inside = (lx <= 0.0) & (0.0 <= hx) & (ly <= 0.0) & (0.0 <= hy)

    def edge_x(ex):           # dx fixed at ex, dy free
        dy = torch.minimum(torch.maximum(-b * ex / c, ly), hy)
        return (a * ex) * ex + 2.0 * (b * ex) * dy + (c * dy) * dy

    def edge_y(ey):           # dy fixed at ey, dx free
        dx = torch.minimum(torch.maximum(-b * ey / a, lx), hx)
        return (a * dx) * dx + 2.0 * (b * dx) * ey + (c * ey) * ey

    q = torch.minimum(torch.minimum(edge_x(lx), edge_x(hx)),
                      torch.minimum(edge_y(ly), edge_y(hy)))
    return torch.where(inside, torch.zeros_like(q), q)


def _saturate_i32(x: torch.Tensor) -> torch.Tensor:
    """f32 count -> int32, saturating at 2^31-1 like XLA's convert."""
    return torch.clamp(x.double(), max=float(I32_MAX)).to(torch.int32)


def _demand(tt: torch.Tensor, budget: int):
    """(num_pairs int32 saturated, overflowed bool) from per-splat tile
    counts vs a kept-pair budget."""
    total_f = tt.float().sum()
    return _saturate_i32(total_f), total_f > budget


def _budget_offsets(kept_tt: torch.Tensor) -> torch.Tensor:
    """Exclusive cumsum of kept-pair counts in f32 (exact to 2^24 kept
    pairs, so the summation order cannot change it)."""
    k = kept_tt.float()
    return torch.cumsum(k, 0) - k


def _enumerate_two_tier(tt, rect_min, rect_w, depth, sid_base, K1, K2, B,
                        grid_x, n_tiles, budget, cull=None,
                        extra_tiers=()):
    """Broadcast-enumerate the (tile key, depth key, sid) streams of
    P*K1 + sum(B_i*K_i) + B*K2 slots (see the JAX docstring). Returns
    (key_tile, key_depth, sid, k_overflowed, n_big, demand_f)."""
    P = tt.shape[0]
    dev = tt.device
    n_big = (tt > K1).sum().to(torch.int32)

    def tile_xy(rm, rw, kk):
        kx = kk % rw[:, None]
        ky = kk // rw[:, None]
        return rm[:, 0:1] + kx, rm[:, 1:2] + ky

    def cull_keep(cl, tx, ty):
        mx, my, ca, cb, cc, qmax = cl
        lx = (tx * cull.tile_w).float() - mx[:, None]
        ly = (ty * cull.tile_h).float() - my[:, None]
        hx = lx + (cull.tile_w - 1)
        hy = ly + (cull.tile_h - 1)
        qmin = _rect_qmin(ca[:, None], cb[:, None], cc[:, None],
                          lx, hx, ly, hy)
        return qmin <= qmax[:, None]

    cl = None
    if cull is not None:
        cl = (cull.mean2d[:, 0], cull.mean2d[:, 1], cull.conic[:, 0],
              cull.conic[:, 1], cull.conic[:, 2], cull.qmax)

    # ---- tier 1: first K1 tiles of every splat ----------------------
    k = torch.arange(K1, dtype=torch.int32, device=dev)
    tx1, ty1 = tile_xy(rect_min, rect_w, k[None, :])
    tile_id1 = ty1 * grid_x + tx1                    # [P, K1]
    in_rect1 = k[None, :] < tt[:, None]
    if cull is not None:
        keep1 = in_rect1 & cull_keep(cl, tx1, ty1)
        k1i = keep1.to(torch.int32)
        rank1 = torch.cumsum(k1i, 1, dtype=torch.int32) - k1i
        ctt1 = k1i.sum(1, dtype=torch.int32)
    else:
        keep1 = in_rect1
        rank1 = k[None, :].expand(P, K1)
        ctt1 = torch.clamp(tt, max=K1)

    # ---- mid tiers + final catch-all: (B_i, slot start S_i, width K_i)
    specs = []
    start = K1
    for (Bi, Ki) in extra_tiers:
        Bi = min(Bi, P)
        Ki = min(Ki, max(n_tiles - start, 0))
        if Bi > 0 and Ki > 0:
            specs.append((Bi, start, Ki))
        start += Ki
    K2_eff = min(K2, max(n_tiles - start, 0))
    if B > 0 and K2_eff > 0:
        specs.append((min(B, P), start, K2_eff))

    def pack(valid, tile_id, rows_depth, rows_sid):
        Kw = tile_id.shape[1]
        return (torch.where(valid, tile_id, n_tiles).reshape(-1),
                rows_depth[:, None].expand(-1, Kw).reshape(-1),
                torch.where(valid, rows_sid[:, None], P).reshape(-1))

    if not specs:
        if K2 > 0 or extra_tiers:
            k_overflowed = n_big > 0
        else:
            k_overflowed = torch.zeros((), dtype=torch.bool, device=dev)
        demand_f = ctt1.float().sum() if cull is not None else None
        off = _budget_offsets(ctt1)
        valid1 = keep1 & (off[:, None] + rank1 < budget)
        key_tile, key_depth, sid = pack(valid1, tile_id1, depth, sid_base)
        return (key_tile.to(torch.int32), key_depth, sid.to(torch.int32),
                k_overflowed, n_big, demand_f)

    # shared register of the biggest splats, ties to the lower index
    # (lax.top_k's order; a stable sort of -tt gives it on any size)
    B_max = max(s[0] for s in specs)
    stt, sidx = torch.sort(-tt, stable=True)
    top_tt, top_idx = -stt[:B_max], sidx[:B_max]

    k_overflowed = torch.zeros((), dtype=torch.bool, device=dev)
    for (Bi, Si, Ki) in specs:
        k_overflowed = k_overflowed | ((tt > Si).sum() > Bi)

    ctt_run = ctt1.clone()                         # kept count per splat
    cov_run = torch.clamp(tt, max=K1)              # no-cull coverage
    tiers_out = []
    for (Bi, Si, Ki) in specs:
        big_tt = top_tt[:Bi]
        big_idx = top_idx[:Bi]
        captured = big_tt > Si
        rw_i = rect_w[big_idx]
        rm_i = rect_min[big_idx]
        ki = Si + torch.arange(Ki, dtype=torch.int32, device=dev)
        tx_i, ty_i = tile_xy(rm_i, rw_i, ki[None, :])
        tile_id_i = ty_i * grid_x + tx_i             # [Bi, Ki]
        in_rect_i = captured[:, None] & (ki[None, :] < big_tt[:, None])
        if cull is not None:
            cl_i = tuple(v[big_idx] for v in cl)
            keep_i = in_rect_i & cull_keep(cl_i, tx_i, ty_i)
            kii = keep_i.to(torch.int32)
            rank_i = (ctt_run[big_idx][:, None]
                      + torch.cumsum(kii, 1, dtype=torch.int32) - kii)
            ctt_i = kii.sum(1, dtype=torch.int32)
            ctt_run = ctt_run.index_add(
                0, big_idx, torch.where(captured, ctt_i, 0))
        else:
            keep_i = in_rect_i
            rank_i = ki[None, :].expand(Bi, Ki)
            cov_i = torch.where(captured, torch.clamp(big_tt - Si, 0, Ki), 0)
            cov_run = cov_run.index_add(0, big_idx, cov_i.to(cov_run.dtype))
        tiers_out.append((keep_i, rank_i, big_idx, tile_id_i))

    if cull is not None:
        kept = ctt_run
        demand_f = kept.float().sum()
    else:
        kept = cov_run
        demand_f = None
    off = _budget_offsets(kept)

    valid1 = keep1 & (off[:, None] + rank1 < budget)
    parts = [pack(valid1, tile_id1, depth, sid_base)]
    for (keep_i, rank_i, big_idx, tile_id_i) in tiers_out:
        valid_i = keep_i & (off[big_idx][:, None] + rank_i < budget)
        parts.append(pack(valid_i, tile_id_i, depth[big_idx],
                          sid_base[big_idx]))
    key_tile, key_depth, sid = (torch.cat(x) for x in zip(*parts))
    return (key_tile.to(torch.int32), key_depth, sid.to(torch.int32),
            k_overflowed, n_big, demand_f)


def _depth_perm(dkey: torch.Tensor, sid_base: torch.Tensor, sort=sort_pairs):
    """Depth-order permutation (rank -> splat id), stable on ties.
    Non-negative IEEE floats order like their int32 bit patterns (depths
    are > 0 past the frustum cull; culled rows carry +inf), so the
    bitcast keys go through the stable int32 pair sort."""
    _, perm = sort(dkey.contiguous().view(torch.int32), sid_base)
    return perm


def _tile_ranges(sorted_tile: torch.Tensor, n_tiles: int):
    q = torch.arange(n_tiles, dtype=sorted_tile.dtype,
                     device=sorted_tile.device)
    starts = torch.searchsorted(sorted_tile, q, right=False)
    ends = torch.searchsorted(sorted_tile, q, right=True)
    return starts.to(torch.int32), (ends - starts).to(torch.int32)


def _finish(key_tile, key_depth, sid, n_tiles, out_len, sort, compact, P):
    """(tile, depth) lexicographic order by two stable radix sorts (depth,
    then tile) over the compacted valid pairs, + per-tile ranges. Valid
    depths are > 0 and fill slots get depth 0.0 and sid ``P``, so the
    depth bitcast is order-preserving; equal (tile, depth) keep
    enumeration order, as in the stable 2-key lax.sort."""
    A = key_tile.numel()
    dev = key_tile.device
    idx = torch.arange(A, dtype=torch.int32, device=dev)
    ctile, cidx = compact(key_tile, idx, n_tiles, out_len, n_tiles, A)
    cidx = cidx.long()
    d = torch.cat([key_depth, key_depth.new_zeros(1)])[cidx]
    s = torch.cat([sid, sid.new_full((1,), P)])[cidx]
    order = torch.arange(out_len, dtype=torch.int32, device=dev)
    _, by_depth = sort(d.contiguous().view(torch.int32), order)
    by_depth = by_depth.long()
    sorted_tile, by_tile = sort(ctile[by_depth], order)
    point_list = s[by_depth[by_tile.long()]]
    tile_starts, tile_counts = _tile_ranges(sorted_tile, n_tiles)
    return point_list, tile_starts, tile_counts


class PairStreams(NamedTuple):
    """The enumerated pair slots before compaction and sort."""
    key: torch.Tensor          # [A] int32: tile << 22 | depth rank on the
    #                            rank path, the tile alone otherwise
    depth: torch.Tensor | None  # [A] f32 depth (fallback path only)
    sid: torch.Tensor          # [A] int32 splat id, P for dropped slots
    rank_key: bool             # True: one packed key (sentinel n_tiles<<22)
    out_len: int               # slots kept after compaction
    k_overflowed: torch.Tensor
    num_big: torch.Tensor
    num_pairs: torch.Tensor
    overflowed: torch.Tensor   # budget overflow only (without k_overflowed)


def enumerate_pairs(proc: ProcessedSplats, grid_x: int, grid_y: int,
                    max_tiles_per_splat: int = 32,
                    max_pairs: int | None = None, big_splats: int = 256,
                    cull: CullSpec | None = None, extra_tiers: tuple = (),
                    rank_key: bool = False,
                    sort=sort_pairs) -> PairStreams:
    """Depth ranks (via ``sort``) and the enumerated pair streams with
    their demand counters: everything ``build_tile_lists`` does before
    compaction."""
    n_tiles = grid_x * grid_y
    P = proc.depth.shape[0]
    K1 = min(max_tiles_per_splat, n_tiles)
    K2 = n_tiles - K1
    B = min(big_splats, P)
    budget = max_pairs if max_pairs is not None else P * K1 + B * K2

    tt = proc.tiles_touched.detach()
    depth = proc.depth.detach()
    rect_w = torch.clamp(proc.rect_max[:, 0] - proc.rect_min[:, 0], min=1)
    sid_base = torch.arange(P, dtype=torch.int32, device=depth.device)

    use_rank = (rank_key and P < (1 << 22)
                and (n_tiles + 1) * (1 << 22) + P < 2 ** 31)
    if use_rank:
        # rank_of_id[p] = depth rank of splat p; culled splats sink last
        dkey = torch.where(tt > 0, depth, torch.full_like(depth, float("inf")))
        perm = _depth_perm(dkey, sid_base, sort)
        rank_of_id = torch.empty_like(sid_base)
        rank_of_id[perm.long()] = sid_base
        depth_key = rank_of_id
    else:
        depth_key = depth

    (key_tile, key_depth, sid, k_overflowed, num_big,
     demand_f) = _enumerate_two_tier(
        tt, proc.rect_min, rect_w, depth_key, sid_base, K1, K2, B,
        grid_x, n_tiles, budget, cull=cull, extra_tiers=extra_tiers)
    A = key_tile.numel()
    if demand_f is None:
        num_pairs, overflowed = _demand(tt, budget)
    else:
        overflowed = demand_f > budget
        num_pairs = _saturate_i32(demand_f)
    if use_rank:
        # invalid pairs carry (n_tiles, rank): they sort after every
        # valid pair since the tile occupies the high bits
        key = (key_tile * (1 << 22) + key_depth).to(torch.int32)
        key_depth = None
    else:
        key = key_tile
    return PairStreams(
        key=key, depth=key_depth, sid=sid, rank_key=use_rank,
        out_len=A if max_pairs is None else min(max_pairs, A),
        k_overflowed=k_overflowed, num_big=num_big, num_pairs=num_pairs,
        overflowed=overflowed)


def build_tile_lists(proc: ProcessedSplats, grid_x: int, grid_y: int,
                     max_tiles_per_splat: int = 32,
                     max_pairs: int | None = None,
                     big_splats: int = 256,
                     cull: CullSpec | None = None,
                     extra_tiers: tuple = (),
                     rank_key: bool = False,
                     key_only: bool = False,
                     compact: bool = False,
                     pallas_sort: bool = False,
                     kernels: bool = True) -> TileLists:
    """Build depth-sorted per-tile splat lists (JAX ``build_tile_lists``
    contract; see the module docstring). ``kernels=False`` runs the plain
    sort and compaction on any device (the reference path); otherwise
    CUDA tensors go through kernels K3 and K4."""
    if key_only:
        raise NotImplementedError(
            "key_only sort is not ported (the CUDA path always sorts the "
            "(key, sid) pair)")
    del compact, pallas_sort    # always compact + radix sort (docstring)
    sort = sort_pairs if kernels else sort_pairs_plain
    comp = compact_pairs if kernels else compact_pairs_plain
    n_tiles = grid_x * grid_y
    P = proc.depth.shape[0]

    s = enumerate_pairs(proc, grid_x, grid_y, max_tiles_per_splat,
                        max_pairs, big_splats, cull, extra_tiers, rank_key,
                        sort)
    if s.rank_key:
        sent = n_tiles << 22
        ckey, csid = comp(s.key, s.sid, sent, s.out_len, sent, P)
        sorted_key, point_list = sort(ckey, csid)
        tile_starts, tile_counts = _tile_ranges(sorted_key >> 22, n_tiles)
    else:
        point_list, tile_starts, tile_counts = _finish(
            s.key, s.depth, s.sid, n_tiles, s.out_len, sort, comp, P)
    return TileLists(point_list=point_list, tile_starts=tile_starts,
                     tile_counts=tile_counts, num_pairs=s.num_pairs,
                     overflowed=s.overflowed | s.k_overflowed,
                     k_overflowed=s.k_overflowed, num_big=s.num_big)
