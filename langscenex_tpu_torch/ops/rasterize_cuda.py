"""Per-tile alpha-compositing blend, forward (kernel K1) and backward
(kernel K2), as one differentiable op.

Port of the JAX ``ops/rasterize_pallas.py`` blend: ``_fwd_kernel`` and
``_bwd_kernel`` behind the custom VJP ``blend_pairs`` and
``blend_tiles_pallas``. Both CUDA kernels run one thread per pixel in
blocks of up to 256 pixels, several blocks per tile, each walking its
tile's depth-sorted pairs front to back with the log-space transmittance
recurrence of the TPU kernel and gathering each pair's row from a
per-splat payload [P, 6 + C] (x, y, conic a/b/c, opacity, C <= 16
channels) into shared memory by cp.async, one batch ahead. The forward
(``csrc/blend.cu``) accumulates the channels in registers. The backward
(``csrc/blend_backward.cu``) re-walks the pairs in forward order with the
same per-pixel step, forms suffix = total - inclusive prefix as the TPU
kernel does, writes each (pair, pixel)'s weight and opacity gradient to
shared memory, then forms each pair's sums over the pixels as products,
one thread per pair and 16-pixel slice, and adds them into a per-splat
row with float atomics.

:func:`blend_tiles` keeps the ``blend_tiles_pallas`` contract ``(accum
[n_tiles, C, npx], T [n_tiles, npx], observe [P] int32)`` with the
``mean2d_abs_hook`` argument: a zero [P, 2] tensor whose gradient receives
each splat's exact sum over pixels of |dL/d mean2d| (the densification
statistic). Gradients flow to mean2d, conic, opacity and channels through
:class:`BlendTilesFn`. On CUDA tensors it launches K1 and K2; on CPU
tensors, or with ``use_pallas=False``, it runs the plain versions:
:func:`blend_tiles_plain`, a torch port of the JAX ``blend_tiles_xla``
that walks every chunk of the longest tile list (the XLA path's
``max_splats_per_tile`` truncation would disagree with the kernel, which
never truncates), and :func:`blend_backward_plain`, the same recurrence
differentiated by hand chunk by chunk (autograd through the plain forward
would keep every chunk's [n_tiles, chunk, npx] intermediates alive).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .. import _build
from .binning import TileLists

ALPHA_MAX = 0.99
ALPHA_MIN = 1.0 / 255.0
T_EPS = 1e-4
MAX_CHANNELS = 16
MAX_TILE_PIXELS = 1024
GEOM_ROWS = 6          # per-splat gradient row: dx, dy, da, db, dc, dop


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


class _Chunk(NamedTuple):
    """One chunk of the plain recurrence: every [n_tiles, CH, npx] tensor
    the forward and the backward need, and the carried (T, done)."""
    ids: torch.Tensor          # [n_tiles, CH] splat id (clamped)
    in_range: torch.Tensor     # [n_tiles, CH]
    dx: torch.Tensor           # mean - pixel, global coordinates
    dy: torch.Tensor
    conic: torch.Tensor        # [n_tiles, CH, 3]
    power: torch.Tensor
    e: torch.Tensor            # exp(power)
    ealpha: torch.Tensor       # opacity * e
    alpha: torch.Tensor        # min(0.99, ealpha)
    gate: torch.Tensor         # in range, power <= 0 and alpha >= 1/255
    T_incl: torch.Tensor       # T after the pair were every gated pair taken
    done_in: torch.Tensor      # [n_tiles, npx] done before the chunk
    include: torch.Tensor
    T_excl: torch.Tensor
    w: torch.Tensor            # alpha * T_excl where included, else 0
    T: torch.Tensor            # [n_tiles, npx] after the chunk
    done: torch.Tensor


def _plain_chunks(lists: TileLists, mean2d, conic, opacity, grid_x: int,
                  grid_y: int, tile_w: int, tile_h: int, chunk: int):
    """Front-to-back compositing in the vectorized masked-cumsum form of
    the JAX ``blend_tiles_xla`` (f32), over ALL pairs of every tile:
    yields one :class:`_Chunk` per chunk of ``chunk`` pairs."""
    n_tiles = grid_x * grid_y
    npx = tile_h * tile_w
    P = mean2d.shape[0]
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
        dx = xy[..., 0:1] - px[:, None, :]                    # [n_tiles,CH,npx]
        dy = xy[..., 1:2] - py[:, None, :]
        power = (-0.5 * (co[..., 0:1] * dx * dx + co[..., 2:3] * dy * dy)
                 - co[..., 1:2] * dx * dy)
        e = torch.exp(power)
        ealpha = op[..., None] * e
        alpha = torch.clamp(ealpha, max=ALPHA_MAX)
        m = in_range[..., None] & (power <= 0.0) & (alpha >= ALPHA_MIN)

        log1m = torch.where(m, torch.log1p(-alpha), 0.0)
        cum_incl = torch.cumsum(log1m, 1)
        T_incl = T[:, None, :] * torch.exp(cum_incl)
        include = m & (T_incl >= T_EPS) & ~done[:, None, :]
        T_excl = T[:, None, :] * torch.exp(cum_incl - log1m)
        w = torch.where(include, alpha * T_excl, 0.0)
        T = T * torch.exp(torch.where(include, log1m, 0.0).sum(1))
        done_in = done
        done = done | (m & (T_incl < T_EPS)).any(1)
        yield _Chunk(ids=ids, in_range=in_range, dx=dx, dy=dy, conic=co,
                     power=power, e=e, ealpha=ealpha, alpha=alpha, gate=m,
                     T_incl=T_incl, done_in=done_in, include=include,
                     T_excl=T_excl, w=w, T=T, done=done)


def blend_tiles_plain(lists: TileLists, mean2d: torch.Tensor,
                      conic: torch.Tensor, opacity: torch.Tensor,
                      channels: torch.Tensor, grid_x: int, grid_y: int,
                      tile_w: int, tile_h: int, chunk: int = 128):
    """The plain forward: device-agnostic reference for kernel K1.
    Returns (accum [n_tiles, C, npx], T [n_tiles, npx], observe [P])."""
    n_tiles = grid_x * grid_y
    npx = tile_h * tile_w
    P = mean2d.shape[0]
    C = channels.shape[1]
    dev = mean2d.device
    T = torch.ones((n_tiles, npx), dtype=torch.float32, device=dev)
    accum = torch.zeros((n_tiles, C, npx), dtype=torch.float32, device=dev)
    observe = torch.zeros((P + 1,), dtype=torch.int32, device=dev)
    for st in _plain_chunks(lists, mean2d, conic, opacity, grid_x, grid_y,
                            tile_w, tile_h, chunk):
        ch = channels[st.ids]                                 # [n_tiles,CH,C]
        accum += torch.bmm(ch.transpose(1, 2), st.w)          # [n_tiles,C,npx]
        obs = (st.include & (st.T_excl > 0.5)).sum(-1, dtype=torch.int32)
        observe.index_add_(0, torch.where(st.in_range, st.ids, P).reshape(-1),
                           torch.where(st.in_range, obs, 0).reshape(-1))
        T = st.T
    return accum, T, observe[:P]


def blend_backward_plain(lists: TileLists, mean2d, conic, opacity, channels,
                         accum, final_T, g_accum, g_T, grid_x: int,
                         grid_y: int, tile_w: int, tile_h: int,
                         chunk: int = 128) -> torch.Tensor:
    """The plain backward: device-agnostic reference for kernel K2.

    Differentiates :func:`blend_tiles_plain` by hand in the TPU kernel's
    forward-order form (suffix = total - inclusive prefix). Returns the
    per-splat gradient rows [P, 8 + C]: (dx, dy, da, db, dc, dop, dch[C],
    abs_x, abs_y), the last two the sums over pixels of |dL/d mean2d|."""
    P, C = channels.shape
    dev = mean2d.device
    g = g_accum                                               # [n_tiles,C,npx]
    tot = (accum * g).sum(1)                                  # [n_tiles,npx]
    tail = (final_T * g_T)[:, None, :]
    prefix = torch.zeros_like(tot)
    grad = torch.zeros((P + 1, GEOM_ROWS + C + 2), dtype=torch.float32,
                       device=dev)
    for st in _plain_chunks(lists, mean2d, conic, opacity, grid_x, grid_y,
                            tile_w, tile_h, chunk):
        chg = torch.bmm(channels[st.ids], g)                  # [n_tiles,CH,npx]
        contrib = st.w * chg
        suffix = tot[:, None, :] - (torch.cumsum(contrib, 1)
                                    + prefix[:, None, :])
        dalpha = torch.where(
            st.include, st.T_excl * chg - (suffix + tail)
            / torch.clamp(1.0 - st.alpha, min=1e-6), 0.0)
        not_clamped = st.ealpha < ALPHA_MAX
        dpower = torch.where(not_clamped, dalpha * st.alpha, 0.0)
        dop = torch.where(not_clamped, dalpha * st.e, 0.0)
        a, b, c = (st.conic[..., k:k + 1] for k in range(3))
        dx, dy = st.dx, st.dy
        d_x = dpower * -(a * dx + b * dy)
        d_y = dpower * -(c * dy + b * dx)
        rows = torch.stack([
            d_x.sum(-1), d_y.sum(-1), (dpower * (-0.5 * dx * dx)).sum(-1),
            (dpower * -(dx * dy)).sum(-1), (dpower * (-0.5 * dy * dy)).sum(-1),
            dop.sum(-1)], -1)                                 # [n_tiles,CH,6]
        dch = torch.bmm(st.w, g.transpose(1, 2))              # [n_tiles,CH,C]
        absr = torch.stack([d_x.abs().sum(-1), d_y.abs().sum(-1)], -1)
        per_pair = torch.cat([rows, dch, absr], -1)
        grad.index_add_(0, torch.where(st.in_range, st.ids, P).reshape(-1),
                        per_pair.reshape(-1, per_pair.shape[-1]))
        prefix = prefix + contrib.sum(1)
    return grad[:P]


def blend_work(lists: TileLists, mean2d, conic, opacity, grid_x: int,
               grid_y: int, tile_w: int, tile_h: int,
               chunk: int = 128) -> dict:
    """What the blend's per-pixel step does on these inputs, counted over
    (pair, pixel) evaluations, whatever implements it (K1, K2 or the plain
    versions): ``walked`` the pairs each pixel walks up to and including
    the one that stops it (T < 1e-4), ``live`` those of them with power
    <= 0 (an exp), ``gated`` those also with alpha >= 1/255 (a log1p), and
    ``included`` those that blend (an exp of log T and the channel
    products). The counts of a kernel's bound: see chip_smoke.py."""
    n = dict(walked=0, live=0, gated=0, included=0)
    for st in _plain_chunks(lists, mean2d, conic, opacity, grid_x, grid_y,
                            tile_w, tile_h, chunk):
        stop = (st.gate & (st.T_incl < T_EPS)).int()
        walked = (st.in_range[..., None] & ~st.done_in[:, None, :]
                  & (torch.cumsum(stop, 1) - stop == 0))
        live = walked & (st.power <= 0.0)
        n["walked"] += int(walked.sum())
        n["live"] += int(live.sum())
        n["gated"] += int((live & (st.alpha >= ALPHA_MIN)).sum())
        n["included"] += int(st.include.sum())
    return n


def _check_inputs(lists: TileLists, n_tiles: int, tile_w: int, tile_h: int,
                  **floats):
    npx = tile_w * tile_h
    dev = lists.point_list.device
    if npx > MAX_TILE_PIXELS:
        raise ValueError(f"blend kernels take tiles of <= {MAX_TILE_PIXELS} "
                         f"pixels, got {tile_w}x{tile_h}")
    for name, t in floats.items():
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


def _payload(mean2d, conic, opacity, channels) -> torch.Tensor:
    C = channels.shape[1]
    if C > MAX_CHANNELS:
        raise ValueError(f"blend kernels take <= {MAX_CHANNELS} channels, "
                         f"got {C}")
    return torch.cat([mean2d, conic, opacity.reshape(-1, 1), channels],
                     dim=1).contiguous()


def _blend_tiles_cuda(lists: TileLists, mean2d, conic, opacity, channels,
                      grid_x: int, grid_y: int, tile_w: int, tile_h: int):
    n_tiles = grid_x * grid_y
    npx = tile_w * tile_h
    P, C = channels.shape
    dev = mean2d.device
    _check_inputs(lists, n_tiles, tile_w, tile_h, mean2d=mean2d, conic=conic,
                  opacity=opacity, channels=channels)
    payload = _payload(mean2d, conic, opacity, channels)
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


def _blend_backward_cuda(lists: TileLists, mean2d, conic, opacity, channels,
                         accum, final_T, g_accum, g_T, grid_x: int,
                         grid_y: int, tile_w: int, tile_h: int):
    n_tiles = grid_x * grid_y
    npx = tile_w * tile_h
    P, C = channels.shape
    dev = mean2d.device
    if npx % 32:
        raise ValueError(f"blend backward kernel takes tiles of a multiple "
                         f"of 32 pixels, got {tile_w}x{tile_h}")
    _check_inputs(lists, n_tiles, tile_w, tile_h, mean2d=mean2d, conic=conic,
                  opacity=opacity, channels=channels, accum=accum,
                  final_T=final_T, g_accum=g_accum, g_T=g_T)
    shapes = dict(accum=(n_tiles, C, npx), final_T=(n_tiles, npx),
                  g_accum=(n_tiles, C, npx), g_T=(n_tiles, npx))
    bufs = dict(accum=accum, final_T=final_T, g_accum=g_accum, g_T=g_T)
    for name, shape in shapes.items():
        if tuple(bufs[name].shape) != shape:
            raise ValueError(f"{name} has shape {tuple(bufs[name].shape)}, "
                             f"expected {shape}")
        bufs[name] = bufs[name].contiguous()
    payload = _payload(mean2d, conic, opacity, channels)
    point_list = lists.point_list.contiguous()
    starts = lists.tile_starts.contiguous()
    counts = lists.tile_counts.contiguous()
    grad = torch.empty((P, GEOM_ROWS + C + 2), dtype=torch.float32,
                       device=dev)
    lib = _build.library()
    code = lib.lsx_blend_backward(
        point_list.data_ptr(), starts.data_ptr(), counts.data_ptr(),
        payload.data_ptr(), bufs["accum"].data_ptr(),
        bufs["final_T"].data_ptr(), bufs["g_accum"].data_ptr(),
        bufs["g_T"].data_ptr(), grad.data_ptr(), n_tiles, grid_x, tile_w,
        tile_h, C, 6 + C, P, _build.stream_ptr(dev))
    _build.launch_counts["blend_backward"] += 1
    _build.check(code, "blend_backward")
    return grad


def _device_kind(t: torch.Tensor, what: str) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {t.device}")
    return t.device.type


def blend_forward(lists: TileLists, mean2d, conic, opacity, channels,
                  grid_x: int, grid_y: int, cfg):
    """Blend forward without autograd: kernel K1 on CUDA tensors,
    :func:`blend_tiles_plain` on CPU tensors."""
    if _device_kind(mean2d, "blend_forward") == "cpu":
        return blend_tiles_plain(lists, mean2d, conic, opacity, channels,
                                 grid_x, grid_y, cfg.tile_w, cfg.tile_h,
                                 cfg.chunk)
    return _blend_tiles_cuda(lists, mean2d, conic, opacity, channels,
                             grid_x, grid_y, cfg.tile_w, cfg.tile_h)


def blend_backward(lists: TileLists, mean2d, conic, opacity, channels,
                   accum, final_T, g_accum, g_T, grid_x: int, grid_y: int,
                   cfg) -> torch.Tensor:
    """Blend backward: kernel K2 on CUDA tensors,
    :func:`blend_backward_plain` on CPU tensors. Returns the per-splat
    gradient rows [P, 8 + C] (see :func:`blend_backward_plain`)."""
    if _device_kind(mean2d, "blend_backward") == "cpu":
        return blend_backward_plain(lists, mean2d, conic, opacity, channels,
                                    accum, final_T, g_accum, g_T, grid_x,
                                    grid_y, cfg.tile_w, cfg.tile_h, cfg.chunk)
    return _blend_backward_cuda(lists, mean2d, conic, opacity, channels,
                                accum, final_T, g_accum, g_T, grid_x, grid_y,
                                cfg.tile_w, cfg.tile_h)


class BlendTilesFn(torch.autograd.Function):
    """(accum, T, observe) = blend(mean2d, conic, opacity, channels) with
    the JAX ``blend_pairs`` VJP: the forward is K1 (or the plain forward)
    and the backward K2 (or the plain backward); ``abs_hook`` [P, 2] is a
    zero input whose gradient is the per-splat sum of |dL/d mean2d| over
    pixels. Tile lists carry no gradient (binning is discrete)."""

    @staticmethod
    def forward(ctx, mean2d, conic, opacity, channels, abs_hook,
                lists: TileLists, grid_x: int, grid_y: int, cfg,
                kernels: bool):
        if kernels:
            accum, T, observe = blend_forward(lists, mean2d, conic, opacity,
                                              channels, grid_x, grid_y, cfg)
        else:
            accum, T, observe = blend_tiles_plain(
                lists, mean2d, conic, opacity, channels, grid_x, grid_y,
                cfg.tile_w, cfg.tile_h, cfg.chunk)
        ctx.save_for_backward(mean2d, conic, opacity, channels, accum, T)
        ctx.lists = lists
        ctx.grid = (grid_x, grid_y)
        ctx.cfg = cfg
        ctx.kernels = kernels
        ctx.has_hook = abs_hook is not None
        ctx.mark_non_differentiable(observe)
        return accum, T, observe

    @staticmethod
    def backward(ctx, g_accum, g_T, _g_observe):
        mean2d, conic, opacity, channels, accum, T = ctx.saved_tensors
        if g_accum is None:
            g_accum = torch.zeros_like(accum)
        if g_T is None:
            g_T = torch.zeros_like(T)
        grid_x, grid_y = ctx.grid
        cfg = ctx.cfg
        args = (ctx.lists, mean2d, conic, opacity, channels, accum, T,
                g_accum, g_T, grid_x, grid_y)
        if ctx.kernels:
            grad = blend_backward(*args, cfg)
        else:
            grad = blend_backward_plain(*args, cfg.tile_w, cfg.tile_h,
                                        cfg.chunk)
        C = channels.shape[1]
        d_hook = grad[:, GEOM_ROWS + C:] if ctx.has_hook else None
        return (grad[:, 0:2], grad[:, 2:5], grad[:, 5].reshape(opacity.shape),
                grad[:, GEOM_ROWS:GEOM_ROWS + C], d_hook,
                None, None, None, None, None)


def blend_tiles(lists: TileLists, mean2d, conic, opacity, channels,
                grid_x: int, grid_y: int, cfg,
                mean2d_abs_hook: Optional[torch.Tensor] = None):
    """Differentiable drop-in for the JAX ``blend_tiles_pallas``: kernels
    K1/K2 on CUDA tensors unless ``cfg.use_pallas`` is False, the plain
    versions otherwise (always on CPU tensors)."""
    kind = _device_kind(mean2d, "blend_tiles")
    kernels = kind == "cuda" and cfg.use_kernels()
    return BlendTilesFn.apply(mean2d, conic, opacity, channels,
                              mean2d_abs_hook, lists, grid_x, grid_y, cfg,
                              kernels)
