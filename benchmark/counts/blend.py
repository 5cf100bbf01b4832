"""Work and least time of the tile blend, forward (K1) and backward (K2),
counted from its inputs whatever implements it.

The walk is the front-to-back compositing step of every tile pixel over
its tile's depth-sorted pairs (alpha = min(0.99, o exp(power)), a pair
blends where power <= 0 and alpha >= 1/255, a pixel stops at the first
such pair that would take its transmittance below 1e-4). ``blend_work``
counts the (pair, pixel) evaluations it makes; ``blend_bound`` turns them
into the least time: the largest of the bytes over the HBM rate, the FP32
operations over 67 TFLOP/s and the special-function operations over 16
per clock and SM at the card's maximum SM clock.
"""
from __future__ import annotations

import torch

from .peaks import PEAK_FP32_FLOPS, SFU_PER_CLOCK_SM, bytes_ms

ALPHA_MAX = 0.99
ALPHA_MIN = 1.0 / 255.0
T_EPS = 1e-4


def tile_pixels(grid_x: int, grid_y: int, tile_w: int, tile_h: int, dev):
    """Pixel (x, y) of every tile pixel, [n_tiles, tile_h*tile_w] each,
    pixels y-major within a tile."""
    n = grid_x * grid_y
    t = torch.arange(n, device=dev)
    tx = (t % grid_x) * tile_w
    ty = (t // grid_x) * tile_h
    ix = torch.arange(tile_w, device=dev)
    iy = torch.arange(tile_h, device=dev)
    px = (tx[:, None, None] + ix[None, None, :]).expand(n, tile_h, tile_w)
    py = (ty[:, None, None] + iy[None, :, None]).expand(n, tile_h, tile_w)
    return (px.reshape(n, -1).float(), py.reshape(n, -1).float())


def blend_work(starts, counts, point_list, mean2d, conic, opacity,
               grid_x: int, grid_y: int, tile_w: int, tile_h: int,
               chunk: int = 128) -> dict:
    """(pair, pixel) evaluations of the walk: ``walked`` up to and
    including the pair that stops a pixel, ``live`` those with power <= 0
    (an exp), ``gated`` those also with alpha >= 1/255 (a log1p) and
    ``included`` those that blend (an exp of log T and the channel
    products)."""
    dev = mean2d.device
    n_tiles = grid_x * grid_y
    starts, counts = starts.long(), counts.long()
    pl = point_list.long()
    L = pl.shape[0]
    P = mean2d.shape[0]
    px, py = tile_pixels(grid_x, grid_y, tile_w, tile_h, dev)
    npx = px.shape[1]
    T = torch.ones((n_tiles, npx), device=dev)
    done = torch.zeros((n_tiles, npx), dtype=torch.bool, device=dev)
    n = dict(walked=0, live=0, gated=0, included=0)
    max_count = int(counts.max()) if n_tiles else 0
    base0 = torch.arange(chunk, device=dev)
    for c0 in range(0, max_count, chunk):
        base = c0 + base0
        in_range = base[None, :] < counts[:, None]
        idx = torch.clamp(starts[:, None] + base[None, :], 0, max(L - 1, 0))
        ids = torch.clamp(torch.where(in_range, pl[idx], 0), max=P - 1)
        xy, co, op = mean2d[ids], conic[ids], opacity[ids]
        dx = xy[..., 0:1] - px[:, None, :]
        dy = xy[..., 1:2] - py[:, None, :]
        power = (-0.5 * (co[..., 0:1] * dx * dx + co[..., 2:3] * dy * dy)
                 - co[..., 1:2] * dx * dy)
        alpha = torch.clamp(op[..., None] * torch.exp(power), max=ALPHA_MAX)
        gate = in_range[..., None] & (power <= 0.0) & (alpha >= ALPHA_MIN)
        log1m = torch.where(gate, torch.log1p(-alpha), 0.0)
        T_incl = T[:, None, :] * torch.exp(torch.cumsum(log1m, 1))
        include = gate & (T_incl >= T_EPS) & ~done[:, None, :]
        stop = (gate & (T_incl < T_EPS)).int()
        walked = (in_range[..., None] & ~done[:, None, :]
                  & (torch.cumsum(stop, 1) - stop == 0))
        live = walked & (power <= 0.0)
        n["walked"] += int(walked.sum())
        n["live"] += int(live.sum())
        n["gated"] += int((live & (alpha >= ALPHA_MIN)).sum())
        n["included"] += int(include.sum())
        T = T * torch.exp(torch.where(include, log1m, 0.0).sum(1))
        done = done | (gate & (T_incl < T_EPS)).any(1)
    return n


def blend_ops(work: dict, n_ch: int, backward: bool) -> tuple:
    """(FP32 operations, special-function operations) of the walk: per
    walked evaluation the power (12), per live one alpha (2) and an exp,
    per gated one log T (2) and a log1p, per included one the weight and
    the channel FMAs (1 + 2C) and the exp of log T. The backward re-walks
    and adds, per included evaluation, the channel gradient, the prefix,
    suffix and dalpha (2C + 10) and its products over pixels (2 (C + 8))."""
    C = n_ch
    fp32 = (12 * work["walked"] + 2 * work["live"] + 2 * work["gated"]
            + (1 + 2 * C) * work["included"])
    if backward:
        fp32 += (2 * C + 10 + 2 * (C + 8)) * work["included"]
    sfu = work["live"] + work["gated"] + work["included"]
    return fp32, sfu


def blend_bytes(n_pairs: int, n_tiles: int, n_splats_read: int, n_splats: int,
                n_ch: int, npx: int, backward: bool) -> int:
    """Bytes each launch has to move at least: the pair ids in use and the
    tile ranges read once, the payload rows (x, y, conic, opacity, C
    channels) of the splats the lists name read once; K1 writes the
    accumulated channels, the final T and the per-splat observe count; K2
    reads those outputs and their gradients and writes the per-splat
    gradient rows (6 geometry + C channels + 2 abs)."""
    f = 4
    read = n_pairs * f + 2 * n_tiles * f + n_splats_read * (6 + n_ch) * f
    img = n_tiles * (n_ch + 1) * npx * f
    if not backward:
        return read + img + n_splats * f
    return read + 2 * img + n_splats * (8 + n_ch) * f


def blend_bound_ms(work: dict, n_ch: int, moved: int, backward: bool,
                   sms: int, mhz: float) -> dict:
    fp32, sfu = blend_ops(work, n_ch, backward)
    terms = dict(bytes=bytes_ms(moved), FP32=fp32 / PEAK_FP32_FLOPS * 1e3,
                 SFU=sfu / (SFU_PER_CLOCK_SM * sms) / (mhz * 1e3))
    term = max(terms, key=terms.get)
    return dict(bound_ms=terms[term], bound_term=term, terms=terms)


def call_bounds(ctx) -> list:
    """K1's and K2's bounds for every blend the traced window ran, from the
    inputs the driver recorded (counted once and kept)."""
    rec = ctx.records
    if "blend_bounds" in rec:
        return rec["blend_bounds"]
    if ctx.device.type != "cuda":
        return []
    from .peaks import max_sm_clock_mhz
    sms = torch.cuda.get_device_properties(ctx.device).multi_processor_count
    mhz = max_sm_clock_mhz()
    out = []
    for c in rec.get("blend", []):
        gx, gy = c["grid"]
        tw, th = c["tile"]
        n_pairs = int(c["counts"].sum())
        work = blend_work(c["starts"], c["counts"], c["point_list"],
                          c["mean2d"], c["conic"], c["opacity"], gx, gy, tw,
                          th)
        read = int(torch.unique(c["point_list"][:n_pairs].long()).numel())
        P = c["mean2d"].shape[0]
        b = {}
        for kind, back in (("fwd", False), ("bwd", True)):
            moved = blend_bytes(n_pairs, gx * gy, read, P, c["n_ch"],
                                tw * th, back)
            b[kind] = blend_bound_ms(work, c["n_ch"], moved, back, sms, mhz)
        out.append(dict(n_pairs=n_pairs, work=work, **b))
    rec["blend_bounds"] = out
    return out


def roofline(ctx, kind: str):
    """K1's ("fwd") or K2's ("bwd") least time over their spans' device
    time, summed over the traced window, in %."""
    ms = ctx.trace.span_device_ms.get(f"bench.blend_{kind}", [])
    bounds = call_bounds(ctx)
    if not ms or not bounds or sum(ms) <= 0 or len(ms) != len(bounds):
        return None
    return sum(b[kind]["bound_ms"] for b in bounds) / sum(ms) * 100.0


def group_floats(group: str, sh_degree: int) -> int:
    """Floats a splat slot holds in one parameter group."""
    return dict(xyz=3, knn_f=6, features_dc=3,
                features_rest=3 * ((sh_degree + 1) ** 2 - 1), scaling=3,
                rotation=4, opacity=1, language_feature=3,
                instance_feature=3)[group]


def step_mfu(ctx):
    """The traced iterations' counted least time over their time, in %:
    K1 and K2 at their bounds, the pair stream compacted and sorted (a
    read and a write of each pair's 8-byte key and 4-byte id, twice) and
    the splat Adam over the groups the phase trains (the traffic's
    ``trained_groups``: every slot's parameters, gradients and two moments
    read, parameters and moments written, 4 bytes each) by bytes."""
    t = ctx.trace
    bounds = call_bounds(ctx)
    if not bounds or not t.units or t.window_s <= 0:
        return None
    least = sum(b["fwd"]["bound_ms"] + b["bwd"]["bound_ms"] for b in bounds)
    least += sum(bytes_ms(4 * b["n_pairs"] * 12) for b in bounds)
    floats = sum(group_floats(g, ctx.config["sh_degree"])
                 for g in ctx.traffic["trained_groups"])
    adam = 7 * 4 * floats * ctx.config["capacity"]
    least += t.units * bytes_ms(adam)
    return least / (t.window_s * 1e3) * 100.0
