"""Per-tile alpha-compositing blend, forward — kernel K1.

Port of the JAX ``ops/rasterize_pallas.py`` forward (``_fwd_kernel``
behind ``blend_tiles_pallas``). The CUDA kernel (``csrc/blend.cu``) runs
one block per tile and one thread per pixel, walks the tile's
depth-sorted pairs front to back with the log-space transmittance
recurrence of the TPU kernel, and gathers each pair's row from a
per-splat payload [P, 6 + C] (x, y, conic a/b/c, opacity, C <= 16
channels) into shared memory — no per-pair payload is staged in HBM.

:func:`blend_tiles` keeps the ``blend_tiles_pallas`` return contract
``(accum [n_tiles, C, npx], T [n_tiles, npx], observe [P] int32)`` and
launches the kernel for CUDA tensors; for CPU tensors it runs
:func:`blend_tiles_plain`, a torch port of the JAX ``blend_tiles_xla``
that walks every chunk of the longest tile list (the XLA path's
``max_splats_per_tile`` truncation would disagree with the kernel, which
never truncates).
"""
from __future__ import annotations

import torch

from .. import _build
from .binning import TileLists

ALPHA_MAX = 0.99
ALPHA_MIN = 1.0 / 255.0
T_EPS = 1e-4
MAX_CHANNELS = 16
MAX_TILE_PIXELS = 1024


def _tile_pixel_coords(grid_x: int, grid_y: int, tile_h: int, tile_w: int,
                       device):
    """Pixel (x, y) of every tile pixel: two [n_tiles, tile_h*tile_w]
    float tensors, pixels flattened y-major."""
    n_tiles = grid_x * grid_y
    t = torch.arange(n_tiles, dtype=torch.int32, device=device)
    tx = (t % grid_x) * tile_w
    ty = (t // grid_x) * tile_h
    ix = torch.arange(tile_w, dtype=torch.int32, device=device)
    iy = torch.arange(tile_h, dtype=torch.int32, device=device)
    px = (tx[:, None, None] + ix[None, None, :]).float()
    py = (ty[:, None, None] + iy[None, :, None]).float()
    npx = tile_h * tile_w
    return (px.expand(n_tiles, tile_h, tile_w).reshape(n_tiles, npx),
            py.expand(n_tiles, tile_h, tile_w).reshape(n_tiles, npx))


def blend_tiles_plain(lists: TileLists, mean2d: torch.Tensor,
                      conic: torch.Tensor, opacity: torch.Tensor,
                      channels: torch.Tensor, grid_x: int, grid_y: int,
                      tile_w: int, tile_h: int, chunk: int = 128):
    """Front-to-back compositing in the vectorized masked-cumsum form of
    the JAX ``blend_tiles_xla`` (f32 throughout), over ALL pairs of every
    tile. Device-agnostic: the reference for kernel K1."""
    n_tiles = grid_x * grid_y
    npx = tile_h * tile_w
    P = mean2d.shape[0]
    C = channels.shape[1]
    dev = mean2d.device
    starts = lists.tile_starts.long()
    counts = lists.tile_counts.long()
    point_list = lists.point_list.long()
    L = point_list.shape[0]
    max_count = int(counts.max()) if n_tiles > 0 else 0
    n_chunks = (max_count + chunk - 1) // chunk

    px, py = _tile_pixel_coords(grid_x, grid_y, tile_h, tile_w, dev)
    T = torch.ones((n_tiles, npx), dtype=torch.float32, device=dev)
    done = torch.zeros((n_tiles, npx), dtype=torch.bool, device=dev)
    accum = torch.zeros((n_tiles, C, npx), dtype=torch.float32, device=dev)
    observe = torch.zeros((P + 1,), dtype=torch.int32, device=dev)
    base0 = torch.arange(chunk, device=dev)
    for ci in range(n_chunks):
        base = ci * chunk + base0                             # [CH]
        in_range = base[None, :] < counts[:, None]            # [n_tiles,CH]
        idx = torch.clamp(starts[:, None] + base[None, :], 0, max(L - 1, 0))
        ids = torch.where(in_range, point_list[idx], 0)
        ids = torch.clamp(ids, max=P - 1)

        xy = mean2d[ids]                                      # [n_tiles,CH,2]
        co = conic[ids]
        op = opacity[ids]
        ch = channels[ids]                                    # [n_tiles,CH,C]
        dx = xy[..., 0:1] - px[:, None, :]                    # [n_tiles,CH,npx]
        dy = xy[..., 1:2] - py[:, None, :]
        power = (-0.5 * (co[..., 0:1] * dx * dx + co[..., 2:3] * dy * dy)
                 - co[..., 1:2] * dx * dy)
        alpha = torch.clamp(op[..., None] * torch.exp(power), max=ALPHA_MAX)
        m = in_range[..., None] & (power <= 0.0) & (alpha >= ALPHA_MIN)

        log1m = torch.where(m, torch.log1p(-alpha), 0.0)
        cum_incl = torch.cumsum(log1m, 1)
        T_incl = T[:, None, :] * torch.exp(cum_incl)
        include = m & (T_incl >= T_EPS) & ~done[:, None, :]
        T_excl = T[:, None, :] * torch.exp(cum_incl - log1m)
        w = torch.where(include, alpha * T_excl, 0.0)
        accum += torch.bmm(ch.transpose(1, 2), w)             # [n_tiles,C,npx]

        obs = (include & (T_excl > 0.5)).sum(-1, dtype=torch.int32)
        observe.index_add_(0, torch.where(in_range, ids, P).reshape(-1),
                           torch.where(in_range, obs, 0).reshape(-1))
        T = T * torch.exp(torch.where(include, log1m, 0.0).sum(1))
        done = done | (m & (T_incl < T_EPS)).any(1)
    return accum, T, observe[:P]


def _blend_tiles_cuda(lists: TileLists, mean2d, conic, opacity, channels,
                      grid_x: int, grid_y: int, tile_w: int, tile_h: int):
    n_tiles = grid_x * grid_y
    npx = tile_w * tile_h
    P, C = channels.shape
    dev = mean2d.device
    if npx > MAX_TILE_PIXELS:
        raise ValueError(f"blend kernel takes tiles of <= {MAX_TILE_PIXELS} "
                         f"pixels, got {tile_w}x{tile_h}")
    if C > MAX_CHANNELS:
        raise ValueError(f"blend kernel takes <= {MAX_CHANNELS} channels, "
                         f"got {C}")
    for name, t in (("mean2d", mean2d), ("conic", conic),
                    ("opacity", opacity), ("channels", channels)):
        if t.device != dev or t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32 on {dev}, got "
                            f"{t.dtype} on {t.device}")
    for name, t in (("point_list", lists.point_list),
                    ("tile_starts", lists.tile_starts),
                    ("tile_counts", lists.tile_counts)):
        if t.device != dev or t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32 on {dev}")
    if lists.tile_starts.numel() != n_tiles:
        raise ValueError("tile_starts does not match the tile grid")
    payload = torch.cat([mean2d, conic, opacity.reshape(-1, 1), channels],
                        dim=1).contiguous()
    point_list = lists.point_list.contiguous()
    starts = lists.tile_starts.contiguous()
    counts = lists.tile_counts.contiguous()
    accum = torch.empty((n_tiles, C, npx), dtype=torch.float32, device=dev)
    final_T = torch.empty((n_tiles, npx), dtype=torch.float32, device=dev)
    observe = torch.empty((P,), dtype=torch.int32, device=dev)
    lib = _build.library()
    code = lib.lsx_blend_forward(
        point_list.data_ptr(), starts.data_ptr(), counts.data_ptr(),
        payload.data_ptr(), accum.data_ptr(), final_T.data_ptr(),
        observe.data_ptr(), n_tiles, grid_x, tile_w, tile_h, C, 6 + C, P,
        _build.stream_ptr(dev))
    _build.launch_counts["blend_forward"] += 1
    _build.check(code, "blend_forward")
    return accum, final_T, observe


def blend_tiles(lists: TileLists, mean2d, conic, opacity, channels,
                grid_x: int, grid_y: int, cfg):
    """Drop-in for the JAX ``blend_tiles_pallas`` (forward): kernel K1 on
    CUDA tensors, :func:`blend_tiles_plain` on CPU tensors."""
    if mean2d.device.type == "cpu":
        return blend_tiles_plain(lists, mean2d, conic, opacity, channels,
                                 grid_x, grid_y, cfg.tile_w, cfg.tile_h,
                                 cfg.chunk)
    if mean2d.device.type != "cuda":
        raise ValueError(f"blend_tiles: unsupported device {mean2d.device}")
    return _blend_tiles_cuda(lists, mean2d, conic, opacity, channels,
                             grid_x, grid_y, cfg.tile_w, cfg.tile_h)
