"""The hand-written CUDA kernels against their plain PyTorch versions on a
CUDA device. This file imports torch only (no JAX), so it also runs on a
machine without JAX:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_kernels_gpu.py

Without a CUDA device the ``gpu`` cases skip (a CUDA kernel has no CPU
mode); the device contract of the wrappers is checked on any machine."""
import dataclasses
import itertools
import math

import numpy as np
import pytest
import torch

from langscenex_tpu_torch.convert import raster_camera_from_numpy
from langscenex_tpu_torch.ops.compaction import (compact_pairs,
                                                 compact_pairs_plain)
from langscenex_tpu_torch.ops.rasterize import RasterConfig, rasterize
from langscenex_tpu_torch import _build
from langscenex_tpu_torch.ops.binning import TileLists
from langscenex_tpu_torch.ops.rasterize import prepare_blend
from langscenex_tpu_torch.ops.rasterize_cuda import (blend_backward,
                                                     blend_backward_plain,
                                                     blend_tiles)
from langscenex_tpu_torch.ops.sort_engine import (SORT_TILE, sort_pairs,
                                                  sort_pairs_plain)
from langscenex_tpu_torch.ops.transforms import (focal2fov, fov2focal,
                                                 projection_matrix)

SENT = 345 << 22


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _pair_stream(rng, n, n_valid, n_splats=100_000):
    key = np.full(n, SENT, np.int32)
    key[:n_valid] = rng.choice(SENT, n_valid, replace=False)
    sid = np.full(n, n_splats, np.int32)
    sid[:n_valid] = rng.integers(0, n_splats, n_valid)
    order = rng.permutation(n)
    return key[order], sid[order]


def test_wrappers_refuse_other_devices():
    # a tensor that is neither on the CPU nor on CUDA never falls back to
    # the plain version
    k = torch.empty(8, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        sort_pairs(k, k)
    with pytest.raises(ValueError, match="unsupported device"):
        compact_pairs(k, k, 3, 8, 3, 0)
    f = torch.empty(4, 2, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        blend_tiles(None, f, f, f, f, 1, 1, RasterConfig())
    with pytest.raises(ValueError, match="unsupported device"):
        blend_backward(None, f, f, f, f, f, f, f, f, 1, 1, RasterConfig())
    from langscenex_tpu_torch.ops.flash_attention import attention_bthd
    from langscenex_tpu_torch.ops.ln_modulate import ln_modulate
    x = torch.empty(1, 4, 2, 64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        attention_bthd(x, x, x)
    m = torch.empty(1, 8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ln_modulate(torch.empty(1, 4, 8, device="meta"), m[0], m[0], m, m, m,
                    m, 2)


def _sort_case(rng, case, n):
    """int32 keys of one of the streams the onesweep sort is sensitive to."""
    if case == "equal":
        return np.full(n, -12345, np.int32)
    if case == "depth":             # bitcast positive f32 and +inf: a skewed
        d = rng.uniform(2.0, 10.0, n).astype(np.float32)    # top digit
        d[rng.uniform(size=n) < 0.1] = np.inf
        d[rng.integers(0, n, n // 10)] = np.float32(5.25)
        return d.view(np.int32)
    if case == "top":               # f32 in [2, 4): the top digit is 0x40
        return rng.uniform(2.0, 4.0, n).astype(np.float32).view(np.int32)
    if case == "extremes":          # INT32_MIN / INT32_MAX and mixed signs
        k = rng.integers(-2 ** 31, 2 ** 31 - 1, n, dtype=np.int64)
        k[rng.uniform(size=n) < 0.1] = -2 ** 31
        k[rng.uniform(size=n) < 0.1] = 2 ** 31 - 1
        return k.astype(np.int32)
    if case == "pairs":             # tile << 22 | rank, clustered by tile
        return ((rng.integers(0, 345, n) << 22)
                | rng.integers(0, 1 << 22, n)).astype(np.int32)
    k = rng.integers(-2 ** 31, 2 ** 31 - 1, n).astype(np.int32)
    k[: n // 3] = 7                 # ties
    return k


@pytest.mark.gpu
@pytest.mark.parametrize("case,n", [
    ("ties", 1), ("ties", 2047), ("ties", 100_003), ("equal", SORT_TILE),
    ("equal", 100_000), ("depth", 100_000), ("depth", 1 << 19),
    ("top", 100_000), ("top", 1 << 19),
    ("extremes", SORT_TILE - 1), ("extremes", SORT_TILE),
    ("extremes", SORT_TILE + 1),
    ("extremes", 1 << 20), ("pairs", 1 << 19)])
def test_sort_kernel_matches_plain(cuda, case, n):
    # K4 bit for bit against the stable sort, at its onesweep tile of keys
    # and one below and above it, on all-equal keys, a skewed top digit,
    # a constant top digit over varying lower digits and the full int32
    # range
    rng = np.random.default_rng(5)
    key = torch.from_numpy(_sort_case(rng, case, n)).to(cuda)
    val = torch.from_numpy(rng.integers(0, 1 << 30, n).astype(
        np.int32)).to(cuda)
    got, ref = sort_pairs(key, val), sort_pairs_plain(key, val)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


@pytest.mark.gpu
def test_sort_kernel_counts_once_and_does_not_synchronise(cuda):
    # one launch count per call, and no host synchronisation inside it
    rng = np.random.default_rng(6)
    key = torch.from_numpy(_sort_case(rng, "ties", 1 << 19)).to(cuda)
    val = torch.arange(1 << 19, dtype=torch.int32, device=cuda)
    sort_pairs(key, val)                 # builds and loads the library
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = sort_pairs(key, val)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert _build.launch_counts["sort_pairs"] == 1
    ref = sort_pairs_plain(key, val)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


@pytest.mark.gpu
def test_compaction_kernel_matches_plain(cuda):
    rng = np.random.default_rng(6)
    for n, n_valid, out_len in ((0, 0, 16), (5000, 4000, 4500),
                                (70_000, 30_000, 40_000)):
        key, sid = _pair_stream(rng, n, n_valid)
        args = (torch.from_numpy(key).to(cuda), torch.from_numpy(sid).to(cuda),
                SENT, out_len, SENT, 100_000)
        got, ref = compact_pairs(*args), compact_pairs_plain(*args)
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


@pytest.mark.gpu
@pytest.mark.parametrize("tile,tiers", [
    ((32, 32), dict(max_tiles_per_splat=8, big_splats=64,
                    extra_tiers=((512, 8),), max_pairs=60_000)),
    ((16, 8), dict(max_tiles_per_splat=16, big_splats=256,
                   extra_tiers=((1024, 16),), max_pairs=120_000))])
def test_rasterize_kernels_match_plain_path(cuda, tile, tiers):
    # dense occlusion (opacity 0.97): the sticky stop and the whole-tile
    # early exit both fire; bounds as in the dense blend test of the JAX
    # package (log-space carry vs cumsum round differently at the stop)
    rng = np.random.default_rng(7)
    P, W, H = 2000, 160, 96
    means = np.stack([rng.uniform(-1.5, 1.5, P), rng.uniform(-1, 1, P),
                      rng.uniform(2, 6, P)], -1).astype(np.float32)
    scales = np.exp(rng.uniform(-3.5, -1.8, (P, 3))).astype(np.float32)
    quats = rng.normal(size=(P, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    opac = np.full(P, 0.97, np.float32)
    shs = (0.4 * rng.normal(size=(P, 16, 3))).astype(np.float32)
    feats = rng.uniform(-1, 1, (P, 11)).astype(np.float32)
    fovy = focal2fov(fov2focal(1.0, W), H)
    cam = raster_camera_from_numpy(np.eye(4), projection_matrix(
        0.01, 100.0, 1.0, fovy), W, H, math.tan(0.5), math.tan(fovy / 2),
        cuda)
    cfg = RasterConfig(tile_w=tile[0], tile_h=tile[1], **tiers)
    t = {k: torch.from_numpy(v).to(cuda) for k, v in dict(
        means=means, scales=scales, quats=quats, opac=opac, shs=shs,
        feats=feats).items()}
    outs = [rasterize(t["means"], t["scales"], t["quats"], t["opac"], cam,
                      torch.zeros(3, device=cuda), shs=t["shs"], sh_degree=3,
                      language_feature=t["feats"][:, :3],
                      instance_feature=t["feats"][:, 3:6],
                      all_map=t["feats"][:, 6:11], cfg=c)
            for c in (cfg, dataclasses.replace(cfg, use_pallas=False))]
    k, r = outs
    assert not bool(k.pairs_overflowed) and int(k.num_pairs) > 4000
    for f in ("color", "language", "instance", "all_map"):
        torch.testing.assert_close(getattr(k, f), getattr(r, f), atol=5e-4,
                                   rtol=1e-3)
    torch.testing.assert_close(k.final_T, r.final_T, atol=1e-4, rtol=0)
    od = (k.out_observe.long() - r.out_observe.long()).abs()
    assert int(od.max()) <= 2 and float((od > 0).float().mean()) < 0.02


def _k2_scene(rng, P, W, H, dense, device):
    means = np.stack([rng.uniform(-1.5, 1.5, P), rng.uniform(-1, 1, P),
                      rng.uniform(2, 6, P)], -1).astype(np.float32)
    scales = np.exp(rng.uniform(-3.5, -1.8, (P, 3))).astype(np.float32)
    quats = rng.normal(size=(P, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    opac = (np.full(P, 0.97) if dense else rng.uniform(0.2, 0.95, P)
            ).astype(np.float32)
    feats = rng.uniform(0, 1, (P, 14)).astype(np.float32)
    fovy = focal2fov(fov2focal(1.0, W), H)
    cam = raster_camera_from_numpy(np.eye(4), projection_matrix(
        0.01, 100.0, 1.0, fovy), W, H, math.tan(0.5), math.tan(fovy / 2),
        device)
    t = [torch.from_numpy(v).to(device) for v in (means, scales, quats,
                                                   opac, feats)]
    return cam, t


@pytest.mark.gpu
@pytest.mark.parametrize("dense,tile", [(False, (32, 32)), (True, (32, 32)),
                                        (False, (128, 8)), (False, (16, 16)),
                                        (True, (16, 8))])
def test_blend_backward_kernel_matches_plain(cuda, dense, tile):
    # K2 against the plain backward on the same lists, forward outputs and
    # upstream gradients. Float atomics sum pairs in a varying order, so
    # each per-splat row is held to 2e-3 of its column's largest magnitude
    # plus 5e-3 relative (the JAX package's Pallas-vs-XLA gradient
    # bounds). The kernel takes dx, dy from the tile centre where the
    # plain version uses global pixel coordinates, so a pair at the
    # alpha >= 1/255 gate or the T < 1e-4 stop may flip at a pixel (as
    # observe does in the forward): the bound holds for all but 1% of
    # splats.
    rng = np.random.default_rng(11)
    P, W, H = 3000, 160, 96
    cam, (means, scales, quats, opac, feats) = _k2_scene(rng, P, W, H, dense,
                                                        cuda)
    cfg = RasterConfig(tile_w=tile[0], tile_h=tile[1], max_pairs=200_000)
    bi = prepare_blend(means, scales, quats, opac, cam,
                       colors_precomp=feats[:, :3],
                       language_feature=feats[:, 3:], cfg=cfg)
    n_tiles = bi.grid_x * bi.grid_y
    npx = tile[0] * tile[1]
    args = (bi.lists, bi.proc.mean2d, bi.proc.conic, bi.opacity,
            bi.channels)
    from langscenex_tpu_torch.ops.rasterize_cuda import blend_forward
    accum, T, _ = blend_forward(*args, bi.grid_x, bi.grid_y, cfg)
    g_accum = torch.from_numpy(rng.normal(size=(n_tiles, 14, npx)).astype(
        np.float32)).to(cuda)
    g_T = torch.from_numpy(rng.normal(size=(n_tiles, npx)).astype(
        np.float32)).to(cuda)
    _build.reset_launch_counts()
    got = blend_backward(*args, accum, T, g_accum, g_T, bi.grid_x,
                         bi.grid_y, cfg)
    torch.cuda.synchronize()
    assert _build.launch_counts["blend_backward"] == 1
    ref = blend_backward_plain(*args, accum, T, g_accum, g_T, bi.grid_x,
                               bi.grid_y, cfg.tile_w, cfg.tile_h, cfg.chunk)
    assert got.shape == ref.shape == (P, 22)
    assert bool(torch.isfinite(got).all())
    scale = ref.abs().amax(0, keepdim=True).clamp(min=1e-3)
    bad = ((got - ref).abs() > 2e-3 * scale + 5e-3 * ref.abs()).any(1)
    assert float(bad.float().mean()) <= 0.01
    assert bool((got[:, 20:] >= 0).all())


# K1 and K2 on synthetic tile lists, for the edges of their design: tiles
# of one part (16x16, 16x8), a tile with no pairs, a tile whose 256-pixel
# parts stop at different pairs (opaque splats over its top rows only), 3
# and 16 channels, opacity 1 (alpha clamped at 0.99 near the means, dop
# and dpower zero there) and lists longer than a batch of either kernel
# that no pixel stops in.
BLEND_CASES = {
    "16x16": dict(tile=(16, 16)),
    "16x8": dict(tile=(16, 8)),
    "empty tile": dict(empty=True),
    "parts stop apart": dict(top_cover=True, n=120),
    "3 channels": dict(C=3),
    "16 channels": dict(C=16),
    "opacity 1": dict(opacity=1.0),
    "long lists": dict(n=900, opacity=0.08),
}


def _synthetic_blend(rng, device, tile=(32, 32), C=14, n=300, empty=False,
                     top_cover=False, opacity=None):
    """A 3x2 grid of tiles, P splats with random means, conics and
    channels, and each tile's list ``n`` random splats in a random depth
    order (tile 1 none with ``empty``; with ``top_cover`` tile 0's list
    starts with 40 opaque splats wide in x and narrow in y over its top
    eight rows)."""
    tw, th = tile
    gx, gy = 3, 2
    P = 2 * n
    mean = np.stack([rng.uniform(-8, gx * tw + 8, P),
                     rng.uniform(-8, gy * th + 8, P)], -1)
    sig = rng.uniform(1.5, 10.0, (P, 2))
    ang = rng.uniform(0, np.pi, P)
    if top_cover:
        mean[:40] = np.stack([rng.uniform(0, tw, 40),
                              rng.uniform(1, 6, 40)], -1)
        sig[:40], ang[:40] = (tw, 2.0), 0.0
    cs_, sn = np.cos(ang), np.sin(ang)
    rot = np.stack([np.stack([cs_, -sn], -1), np.stack([sn, cs_], -1)], -2)
    cov = rot @ (sig[:, :, None] ** 2 * np.swapaxes(rot, 1, 2))
    inv = np.linalg.inv(cov)
    conic = np.stack([inv[:, 0, 0], inv[:, 0, 1], inv[:, 1, 1]], -1)
    op = (np.full(P, opacity) if opacity is not None
          else rng.uniform(0.2, 0.95, P))
    if top_cover:
        op[:40] = 0.97
    lists = []
    for t in range(gx * gy):
        ids = rng.permutation(P)[:n]
        if top_cover and t == 0:
            ids = np.concatenate([np.arange(40), ids[~np.isin(ids,
                                                              np.arange(40))]])
        if empty and t == 1:
            ids = ids[:0]
        lists.append(ids.astype(np.int32))
    counts = np.array([len(x) for x in lists], np.int32)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int32)
    t = lambda a, dt=torch.float32: torch.from_numpy(  # noqa: E731
        np.ascontiguousarray(a)).to(device=device, dtype=dt)
    zero = torch.zeros((), dtype=torch.int32, device=device)
    tl = TileLists(t(np.concatenate(lists), torch.int32), t(starts,
                   torch.int32), t(counts, torch.int32), zero,
                   zero.bool(), zero.bool(), zero)
    ch = rng.uniform(-1, 1, (P, C))
    return (tl, t(mean), t(conic), t(op), t(ch), gx, gy), RasterConfig(
        tile_w=tw, tile_h=th)


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(BLEND_CASES))
def test_blend_kernels_match_plain_at_design_edges(cuda, case):
    # bounds as in the tests above: K1's of the dense blend test, K2's of
    # the JAX package's Pallas-vs-XLA gradients for all but 1% of splats
    from langscenex_tpu_torch.ops.rasterize_cuda import (blend_forward,
                                                         blend_tiles_plain)
    rng = np.random.default_rng(sorted(BLEND_CASES).index(case))
    args, cfg = _synthetic_blend(rng, cuda, **BLEND_CASES[case])
    lists, P, C = args[0], args[1].shape[0], args[4].shape[1]
    n_tiles, npx = args[5] * args[6], cfg.tile_w * cfg.tile_h
    _build.reset_launch_counts()
    accum, T, obs = blend_forward(*args, cfg)
    torch.cuda.synchronize()
    assert _build.launch_counts["blend_forward"] == 1
    ra, rT, robs = blend_tiles_plain(*args, cfg.tile_w, cfg.tile_h,
                                     cfg.chunk)
    torch.testing.assert_close(accum, ra, atol=5e-4, rtol=1e-3)
    torch.testing.assert_close(T, rT, atol=1e-4, rtol=0)
    od = (obs.long() - robs.long()).abs()
    assert int(od.max()) <= 2 and float((od > 0).float().mean()) < 0.02
    if BLEND_CASES[case].get("empty"):
        assert int(lists.tile_counts[1]) == 0
        assert bool((T[1] == 1).all()) and bool((accum[1] == 0).all())
    if BLEND_CASES[case].get("top_cover"):
        # the top part of tile 0 stops, its other parts walk on
        assert float(T[0, :256].max()) < 0.01 < float(T[0, 256:].max())
    g_accum = torch.from_numpy(rng.normal(size=(n_tiles, C, npx)).astype(
        np.float32)).to(cuda)
    g_T = torch.from_numpy(rng.normal(size=(n_tiles, npx)).astype(
        np.float32)).to(cuda)
    got = blend_backward(*args[:5], accum, T, g_accum, g_T, *args[5:], cfg)
    torch.cuda.synchronize()
    assert _build.launch_counts["blend_backward"] == 1
    ref = blend_backward_plain(*args[:5], accum, T, g_accum, g_T, *args[5:],
                               cfg.tile_w, cfg.tile_h, cfg.chunk)
    assert got.shape == ref.shape == (P, 8 + C)
    assert bool(torch.isfinite(got).all())
    scale = ref.abs().amax(0, keepdim=True).clamp(min=1e-3)
    bad = ((got - ref).abs() > 2e-3 * scale + 5e-3 * ref.abs()).any(1)
    assert float(bad.float().mean()) <= 0.01
    assert bool((got[:, -2:] >= 0).all())


def _qkv(rng, B, T, H, device, layout=None):
    """bf16 q, k, v [B, T, H, 64] with unit-variance rows (as after the
    DiT's qk-LayerNorm); ``layout="qkv"`` gives strided views of one
    [B, T, 3, H, 64] tensor, which the kernel reads through its strides."""
    x = torch.from_numpy(rng.normal(size=(B, T, 3, H, 64)).astype(
        np.float32)).to(device=device, dtype=torch.bfloat16)
    if layout == "qkv":
        return x[:, :, 0], x[:, :, 1], x[:, :, 2]
    return tuple(x[:, :, i].contiguous() for i in range(3))


@pytest.mark.gpu
@pytest.mark.parametrize("B,T,H,layout", [(1, 300, 4, None), (2, 64, 2, None),
                                          (1, 1, 1, None),
                                          (2, 200, 3, "qkv")])
def test_flash_attention_kernel_matches_plain(cuda, B, T, H, layout):
    # K5 against the plain version with the same rounding points. The f32
    # sums run in another order (and exp2 differs in its last bits), which
    # can move a p across a bf16 rounding boundary and an output by one
    # bf16 ulp: o within 2^-7 relative + 1e-3, l2 (f32) within 1e-4
    from langscenex_tpu_torch.ops.flash_attention import (
        attention_bthd_kernel, attention_bthd_plain)
    q, k, v = _qkv(np.random.default_rng(20), B, T, H, cuda, layout)
    _build.reset_launch_counts()
    o, l2 = attention_bthd_kernel(q, k, v, 0.125)
    torch.cuda.synchronize()
    assert _build.launch_counts["flash_attention"] == 1
    ro, rl2 = attention_bthd_plain(q, k, v, 0.125)
    assert o.shape == (B, T, H, 64) and l2.shape == (B * H, T)
    assert bool(torch.isfinite(o.float()).all())
    torch.testing.assert_close(o.float(), ro.float(), atol=1e-3,
                               rtol=2 ** -7)
    torch.testing.assert_close(l2, rl2, atol=1e-4, rtol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("B,T,H,layout", [(1, 300, 4, None),
                                          (2, 128, 2, None),
                                          (2, 200, 3, "qkv")])
def test_flash_attention_backward_kernel_matches_plain(cuda, B, T, H,
                                                       layout):
    # K7 against the plain backward on K5's o and l2 and a random do, with
    # the same rounding points (q' in bf16, ds and the p of the dv product
    # rounded to bf16). The f32 sums run in another order (dq's through
    # atomics, in an order that varies from run to run), so an output can
    # land one bf16 ulp away (at most 2^-7 relative), and a ds next to a
    # rounding midpoint can round the other way, moving its sum by 2^-8 of
    # that one term: 2^-7 relative + 2^-8 of the largest gradient of each
    # kind. Only outputs next to a midpoint move, so each relative RMS
    # difference stays under 2^-9 (a dropped 64-row tile moves it by more
    # than sqrt(64 / 600) = 0.33)
    from langscenex_tpu_torch.ops.flash_attention import (
        attention_bthd_backward_kernel, attention_bthd_backward_plain,
        attention_bthd_kernel)
    rng = np.random.default_rng(23)
    q, k, v = _qkv(rng, B, T, H, cuda, layout)
    do = torch.from_numpy(rng.normal(size=(B, T, H, 64)).astype(
        np.float32)).to(cuda, torch.bfloat16)
    o, l2 = attention_bthd_kernel(q, k, v, 0.125)
    _build.reset_launch_counts()
    got = attention_bthd_backward_kernel(q, k, v, o, l2, do, 0.125)
    torch.cuda.synchronize()
    assert _build.launch_counts["flash_attention_backward"] == 1
    ref = attention_bthd_backward_plain(q, k, v, o, l2, do, 0.125)
    for name, g, r in zip("qkv", got, ref):
        assert g.shape == (B, T, H, 64) and g.dtype == torch.bfloat16
        assert bool(torch.isfinite(g.float()).all()), name
        g, r = g.float(), r.float()
        torch.testing.assert_close(g, r, rtol=2 ** -7,
                                   atol=2 ** -8 * float(r.abs().max()),
                                   msg=f"d{name}")
        rel = float((g - r).pow(2).mean().sqrt() / r.pow(2).mean().sqrt())
        assert rel < 2 ** -9, (name, rel)


@pytest.mark.gpu
def test_flash_attention_refuses_and_backward_is_finite(cuda):
    from langscenex_tpu_torch.ops.flash_attention import (
        attention_bthd, attention_bthd_backward_kernel)
    q, k, v = _qkv(np.random.default_rng(21), 1, 16, 2, cuda)
    with pytest.raises(ValueError, match="head_dim"):
        attention_bthd(q[..., :32], k[..., :32], v[..., :32])
    with pytest.raises(TypeError, match="bf16"):
        attention_bthd(q, k, v, dtype=torch.float32)
    l2 = torch.zeros(2, 16, device=cuda)
    with pytest.raises(TypeError, match="bf16"):
        attention_bthd_backward_kernel(q.float(), k, v, q, l2, q, 0.125)
    with pytest.raises(ValueError, match="l2"):
        attention_bthd_backward_kernel(q, k, v, q, None, q, 0.125)
    with pytest.raises(ValueError, match="head_dim"):
        attention_bthd_backward_kernel(q[..., :32], k[..., :32], v[..., :32],
                                       q[..., :32], l2, q[..., :32], 0.125)
    # the autograd path: K5 forward, K7 backward, gradients of every input
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    _build.reset_launch_counts()
    attention_bthd(*leaves).float().sum().backward()
    torch.cuda.synchronize()
    assert _build.launch_counts["flash_attention"] == 1
    assert _build.launch_counts["flash_attention_backward"] == 1
    for t in leaves:
        assert t.grad is not None and bool(torch.isfinite(
            t.grad.float()).all())
    assert float(leaves[2].grad.float().abs().sum()) > 0


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,T,Tk,view", [(1, 4, 300, 300, False),
                                           (2, 3, 130, 200, True),
                                           (1, 2, 384, 640, False),
                                           (2, 2, 200, 70, True),
                                           (1, 1, 1, 1, False)])
def test_flash_attention_bhtd_kernel_matches_plain(cuda, B, H, T, Tk, view):
    # K6 against its plain version in [B, H, T, D], with Tk != T and
    # lengths that are not multiples of 64, on contiguous tensors and on
    # transpose(1, 2) views of [B, T, H, D] ones. Bounds as K5's: o within
    # 2^-7 relative + 1e-3, l2 within 1e-4
    from langscenex_tpu_torch.ops.flash_attention import (
        flash_attention_kernel, flash_attention_plain)
    rng = np.random.default_rng(24)

    def mk(n):
        shape = (B, n, H, 64) if view else (B, H, n, 64)
        x = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(
            cuda, torch.bfloat16)
        return x.transpose(1, 2) if view else x
    q, k, v = mk(T), mk(Tk), mk(Tk)
    _build.reset_launch_counts()
    o, l2 = flash_attention_kernel(q, k, v, 0.125)
    torch.cuda.synchronize()
    assert _build.launch_counts == {**{n: 0 for n in _build.launch_counts},
                                    "flash_attention_bhtd": 1}
    ro, rl2 = flash_attention_plain(q, k, v, 0.125)
    assert o.shape == (B, H, T, 64) and l2.shape == (B * H, T)
    assert bool(torch.isfinite(o.float()).all())
    torch.testing.assert_close(o.float(), ro.float(), atol=1e-3,
                               rtol=2 ** -7)
    torch.testing.assert_close(l2, rl2, atol=1e-4, rtol=1e-5)


def _bounded_inputs(rng, B, H, T, Tk, device, layout, logits):
    """(q [B, H, T, 64], k, v [B, H, Tk, 64] bf16, scale) for the bounded
    forward (K5 on their transpose(1, 2) views, K6 on them). ``layout``:
    ``"bhtd"`` contiguous [B, H, n, 64] tensors, ``"bthd"`` views of
    contiguous [B, n, H, 64] ones, ``"qkv"`` views of one
    [B, T, 3, H, 64] tensor (Tk = T). ``logits``: ``"unit"`` unit-normal
    entries at scale 1/8; ``"low"`` as unit, then k = |k| and q's first
    row -16 in every entry, so that its logits lie below about -100 and
    its l under 1e-30 (the max(l, 1e-30) path, with o = acc / 1e-30 not
    0); ``"high"`` integer q in [-3, 3] and k in [-1, 1] at scale
    1/log2(e), so that q' = q and every logit is an integer, exact in any
    order of summation, up to about 60: p up to about 2^60."""
    def draw(shape, kind):
        if logits == "high" and kind != "v":
            top = 3 if kind == "q" else 1
            return rng.integers(-top, top + 1, size=shape).astype(np.float32)
        return rng.normal(size=shape).astype(np.float32)

    def put(x):
        return torch.from_numpy(x).to(device, torch.bfloat16)

    if layout == "qkv":
        x = put(np.stack([draw((B, T, H, 64), kind) for kind in "qkv"], 2))
        q, k, v = (x[:, :, i].transpose(1, 2) for i in range(3))
    else:
        def mk(n, kind):
            if layout == "bthd":
                return put(draw((B, n, H, 64), kind)).transpose(1, 2)
            return put(draw((B, H, n, 64), kind))
        q, k, v = mk(T, "q"), mk(Tk, "k"), mk(Tk, "v")
    if logits == "low":
        k.abs_()
        q[:, :, 0] = -16.0
    return q, k, v, (1.0 / math.log2(math.e) if logits == "high" else 0.125)


# the bounded forward (K5, K6) beyond the cases above: every T of (1, 129,
# 300) with every Tk of (1, 100, 127, 128, 129, 257) (the edges of the
# 128-key tile), B = 1 and 2, on contiguous tensors and transpose(1, 2)
# views; the qkv layout; rows whose logits all lie far below 0; logits up
# to about 60
BOUNDED_CASES = [
    *[(1 + i % 2, 3, T, Tk, ("bhtd", "bthd")[i % 2], "unit")
      for i, (T, Tk) in enumerate(itertools.product(
          (1, 129, 300), (1, 100, 127, 128, 129, 257)))],
    (2, 3, 129, 129, "qkv", "unit"), (1, 3, 257, 257, "qkv", "unit"),
    (2, 1, 1, 1, "qkv", "unit"),
    (2, 3, 300, 257, "bthd", "low"), (1, 3, 129, 100, "bhtd", "low"),
    (2, 3, 257, 257, "bthd", "low"), (1, 3, 129, 129, "qkv", "low"),
    (2, 3, 300, 257, "bhtd", "high"), (1, 2, 129, 129, "qkv", "high"),
    (2, 3, 300, 300, "bthd", "high"), (1, 2, 257, 257, "bhtd", "high")]


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,T,Tk,layout,logits", BOUNDED_CASES)
def test_bounded_kernels_at_key_tile_edges(cuda, B, H, T, Tk, layout,
                                           logits):
    # K6 against its plain version and, where T == Tk, K5 on the
    # [B, T, H, D] views of the same tensors, bit for bit K6's. o within
    # 2^-7 relative + 1e-3, as above. l2: with integer logits ("high") s is
    # exact in any order of summation, and l2 is held within 1e-4 + 1e-5
    # relative, as above; otherwise s's f32 sums run in another order than
    # the plain version's and can move a p across a bf16 rounding boundary.
    # Any number of p one bf16 ulp away move l by at most 2^-7 of it: each
    # l2 within log2(1 + 2^-7) < 1.13e-2 (K9's bound) and, on average over
    # the rows, within 1e-4. (On an H100 one row in each of four unit cases
    # here moved by 2.1e-4 to 5.1e-4: one p of about a tenth of its row's
    # l, one ulp away.) A row whose logits all lie below about -100 takes
    # l2 = log2(1e-30) exactly, and o = acc / 1e-30, not 0
    from langscenex_tpu_torch.ops.flash_attention import (
        attention_bthd_kernel, flash_attention_kernel, flash_attention_plain)
    q, k, v, sc = _bounded_inputs(np.random.default_rng(24), B, H, T, Tk,
                                  cuda, layout, logits)
    _build.reset_launch_counts()
    o, l2 = flash_attention_kernel(q, k, v, sc)
    torch.cuda.synchronize()
    assert _build.launch_counts == {**{n: 0 for n in _build.launch_counts},
                                    "flash_attention_bhtd": 1}
    ro, rl2 = flash_attention_plain(q, k, v, sc)
    assert o.shape == (B, H, T, 64) and l2.shape == (B * H, T)
    assert bool(torch.isfinite(o.float()).all())
    torch.testing.assert_close(o.float(), ro.float(), atol=1e-3,
                               rtol=2 ** -7)
    if logits == "high":
        torch.testing.assert_close(l2, rl2, atol=1e-4, rtol=1e-5)
        s = q.float() @ k.float().transpose(-1, -2)
        assert float(s.max()) >= 50.0
    else:
        torch.testing.assert_close(l2, rl2, atol=1.13e-2, rtol=1e-5)
        assert float((l2 - rl2).abs().mean()) < 1e-4
    if logits == "low":
        floor = float(np.log2(np.float32(1e-30)))
        for x in (l2, rl2):
            assert bool((x.view(B, H, T)[:, :, 0] == floor).all())
        assert float(ro[:, :, 0].float().abs().max()) > 0
    if T == Tk:
        o5, l5 = attention_bthd_kernel(
            *(t.transpose(1, 2) for t in (q, k, v)), sc)
        torch.cuda.synchronize()
        assert _build.launch_counts["flash_attention"] == 1
        assert torch.equal(o5.transpose(1, 2), o) and torch.equal(l5, l2)


@pytest.mark.parametrize("kernel", ["flash_attention_kernel",
                                    "flash_attention_online_kernel",
                                    "flash_attention_h2_kernel",
                                    "flash_attention_exp2_kernel",
                                    "flash_attention_exp2_bf16_kernel"])
def test_forward_wrappers_refuse_no_keys(kernel):
    # Tk = 0 leaves the softmax nothing to normalise over: the wrappers of
    # the [B, H, T, D] forwards (K6, K9, K11, K13a/b) raise before any
    # launch, on the card and, ahead of their device check, on the CPU
    from langscenex_tpu_torch.ops import flash_attention as fa
    dev = "cuda" if torch.cuda.is_available() else "cpu"
    q = torch.zeros((1, 2, 4, 64), dtype=torch.bfloat16, device=dev)
    kv = torch.zeros((1, 2, 0, 64), dtype=torch.bfloat16, device=dev)
    _build.reset_launch_counts()
    with pytest.raises(ValueError, match="at least one key"):
        getattr(fa, kernel)(q, kv, kv, 0.125)
    assert not any(_build.launch_counts.values())


@pytest.mark.gpu
def test_flash_attention_bhtd_matches_k5_and_dispatch(cuda):
    # K6 and K5 share their device code: on the same tensors (K6 on the
    # [B, H, T, D] views) o and l2 are bit-identical. flash_attention's
    # autograd runs K6 and K7 (on [B, H, T, D] views), with Tk != T too;
    # attention_auto takes K6 from the threshold on, and K9 for unbounded
    # logits, as flash_attention does
    from langscenex_tpu_torch.ops.flash_attention import (
        attention_auto, attention_bthd_kernel, flash_attention,
        flash_attention_kernel, flash_attention_online_kernel)
    q, k, v = _qkv(np.random.default_rng(25), 2, 200, 3, cuda, "qkv")
    o5, l5 = attention_bthd_kernel(q, k, v, 0.125)
    o6, l6 = flash_attention_kernel(*(t.transpose(1, 2) for t in (q, k, v)),
                                    0.125)
    assert torch.equal(o6.transpose(1, 2), o5) and torch.equal(l6, l5)
    leaves = [t.transpose(1, 2).clone().requires_grad_() for t in (q, k, v)]
    _build.reset_launch_counts()
    flash_attention(*leaves, bounded_logits=True).float().sum().backward()
    torch.cuda.synchronize()
    assert _build.launch_counts["flash_attention_bhtd"] == 1
    assert _build.launch_counts["flash_attention_backward"] == 1
    assert _build.launch_counts["flash_attention"] == 0
    for t in leaves:
        assert bool(torch.isfinite(t.grad.float()).all())
    kv = [t.transpose(1, 2)[:, :, :100].detach().requires_grad_()
          for t in (k, v)]
    qd = leaves[0].detach().requires_grad_()
    flash_attention(qd, *kv, bounded_logits=True).float().sum().backward()
    torch.cuda.synchronize()
    assert _build.launch_counts["flash_attention_backward"] == 2
    assert qd.grad.shape == qd.shape
    for t in kv:
        assert t.grad.shape == (2, 3, 100, 64)
        assert bool(torch.isfinite(t.grad.float()).all())
    qh = q.transpose(1, 2)
    _build.reset_launch_counts()
    attention_auto(qh, qh, qh, bounded_logits=True, flash_threshold=128)
    assert _build.launch_counts["flash_attention_bhtd"] == 1
    attention_auto(qh, qh, qh, bounded_logits=True, flash_threshold=256)
    assert _build.launch_counts["flash_attention_bhtd"] == 1
    got = attention_auto(qh, qh, qh, bounded_logits=False,
                         flash_threshold=128)
    assert _build.launch_counts["flash_attention_online"] == 1
    want, _ = flash_attention_online_kernel(qh, qh, qh, 0.125)
    assert torch.equal(got, want)
    assert torch.equal(flash_attention(qh, qh, qh), want)
    assert _build.launch_counts["flash_attention_online"] == 3
    assert _build.launch_counts["flash_attention_bhtd"] == 1


def _bhtd(rng, B, H, n, device, view, mag=1.0):
    """A seeded [B, H, n, 64] bf16 tensor, or the transpose(1, 2) view of a
    [B, n, H, 64] one."""
    shape = (B, n, H, 64) if view else (B, H, n, 64)
    x = torch.from_numpy((rng.normal(size=shape) * mag).astype(
        np.float32)).to(device, torch.bfloat16)
    return x.transpose(1, 2) if view else x


def _online_inputs(rng, B, H, T, Tk, device, view, mag):
    """q [B, H, T, 64] and k, v [B, H, Tk, 64] for the online forwards, q
    and k scaled by |mag|. A negative ``mag`` makes every entry of k
    positive and of q's first row negative, so that all the logits of that
    row are below 0."""
    q, k, v = (_bhtd(rng, B, H, n, device, view, m)
               for n, m in ((T, abs(mag)), (Tk, abs(mag)), (Tk, 1.0)))
    if mag < 0:
        k = k.abs()
        q[:, :, 0] = -q[:, :, 0].abs()
    return q, k, v


# the edges of the wgmma forwards' tiling (128 queries in two consumers of
# 64, 128 keys): T = 100 leaves the second consumer a partial tile, T = 1
# none; Tk = 130 and 257 have a masked last tile, above and below T; 3
# heads give an odd B·H; a negative mag gives a row whose logits are all
# below 0 (_online_inputs); B = 2 with Tk < 128 (a masked first tile) and
# with a masked last tile
WGMMA_EDGES = [(1, 3, 100, 100, False, 1.0), (1, 3, 100, 257, True, 1.0),
               (1, 3, 200, 130, True, 1.0), (1, 3, 1, 257, False, 1.0),
               (1, 3, 200, 200, False, -1.0), (1, 3, 200, 257, True, 20.0),
               (2, 3, 200, 100, True, -1.0), (2, 3, 130, 300, False, 1.0)]


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,T,Tk,view,mag", [(1, 4, 300, 300, False, 1.0),
                                               (2, 3, 130, 200, True, 1.0),
                                               (1, 2, 384, 640, False, 1.0),
                                               (2, 2, 200, 70, True, 1.0),
                                               (1, 1, 1, 1, False, 1.0),
                                               (1, 2, 128, 192, False, 20.0),
                                               *WGMMA_EDGES])
def test_online_kernels_match_plain(cuda, B, H, T, Tk, view, mag):
    # K9 and K11 against their plain versions at the kernels' 128-key tile
    # (the same rescale points), Tk != T, tails, views, x20 logits (where
    # K6's bounded softmax overflows) and the edges of the wgmma forward's
    # tiling. As K6's bounds: o within 2^-7 relative +
    # 1e-3; K9's l2 within log2(1 + 2^-7) < 1.13e-2 (a p one bf16 ulp away
    # moves l by at most 2^-7 of it) and, at unit logits, within 1e-4 on
    # average over the rows
    from langscenex_tpu_torch.ops.flash_attention import (
        WGMMA_BLOCK_K, flash_attention_h2_kernel,
        flash_attention_h2_plain, flash_attention_online_kernel,
        flash_attention_online_plain)
    rng = np.random.default_rng(26)
    q, k, v = _online_inputs(rng, B, H, T, Tk, cuda, view, mag)
    _build.reset_launch_counts()
    o, l2 = flash_attention_online_kernel(q, k, v, 0.125)
    oh = flash_attention_h2_kernel(q, k, v, 0.125)
    torch.cuda.synchronize()
    assert _build.launch_counts == {**{n: 0 for n in _build.launch_counts},
                                    "flash_attention_online": 1,
                                    "flash_attention_h2": 1}
    ro, rl2 = flash_attention_online_plain(q, k, v, 0.125,
                                           block_k=WGMMA_BLOCK_K)
    rh = flash_attention_h2_plain(q, k, v, 0.125, block_k=WGMMA_BLOCK_K)
    assert o.shape == oh.shape == (B, H, T, 64) and l2.shape == (B * H, T)
    for got, ref in ((o, ro), (oh, rh)):
        assert bool(torch.isfinite(got.float()).all())
        torch.testing.assert_close(got.float(), ref.float(), atol=1e-3,
                                   rtol=2 ** -7)
    torch.testing.assert_close(l2, rl2, atol=1.13e-2, rtol=1e-5)
    if mag == 1.0:
        assert float((l2 - rl2).abs().mean()) < 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,T,Tk,view", [(1, 3, 300, 130, False),
                                           (2, 2, 130, 200, True),
                                           (1, 2, 64, 640, False),
                                           (2, 3, 200, 100, True),
                                           (2, 2, 130, 257, False)])
def test_backward_kernel_with_own_key_length_matches_plain(cuda, B, H, T, Tk,
                                                           view):
    # K7 with Tk != T (K12's split backward, served by K7) on K9's o and
    # l2 (Tk < 128 and Tk % 128 != 0 among them, B = 2), against the plain
    # backward on the same: K7's bounds (see
    # test_flash_attention_backward_kernel_matches_plain)
    from langscenex_tpu_torch.ops.flash_attention import (
        flash_attention_backward_kernel, flash_attention_backward_plain,
        flash_attention_online_kernel)
    rng = np.random.default_rng(27)
    q, do = (_bhtd(rng, B, H, T, cuda, view) for _ in range(2))
    k, v = (_bhtd(rng, B, H, Tk, cuda, view) for _ in range(2))
    o, l2 = flash_attention_online_kernel(q, k, v, 0.125)
    _build.reset_launch_counts()
    got = flash_attention_backward_kernel(q, k, v, o, l2, do, 0.125)
    torch.cuda.synchronize()
    assert _build.launch_counts["flash_attention_backward"] == 1
    ref = flash_attention_backward_plain(q, k, v, o, l2, do, 0.125)
    for name, g, r, n in zip("qkv", got, ref, (T, Tk, Tk)):
        assert g.shape == (B, H, n, 64) and g.dtype == torch.bfloat16
        assert bool(torch.isfinite(g.float()).all()), name
        g, r = g.float(), r.float()
        torch.testing.assert_close(g, r, rtol=2 ** -7,
                                   atol=2 ** -8 * float(r.abs().max()),
                                   msg=f"d{name}")
        rel = float((g - r).pow(2).mean().sqrt() / r.pow(2).mean().sqrt())
        assert rel < 2 ** -9, (name, rel)


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,T,Tk,view", [
    (1, 2, 63, 127, False), (1, 2, 64, 128, True), (2, 2, 65, 129, False),
    (1, 2, 200, 127, True), (2, 3, 200, 128, False), (1, 2, 64, 129, True),
    (1, 24, 130, 129, True), (1, 48, 65, 200, False)])
def test_backward_kernel_at_key_tile_edges(cuda, B, H, T, Tk, view):
    # K7 at the edges of its 128-key block and 64-query step (one key or
    # query below, at and above), B = 2, [B, H, T, D] views read through
    # their strides and the DiT's 24 (TP shard) and 48 heads, on K9's o and
    # l2: K7's bounds (see test_flash_attention_backward_kernel_matches_plain)
    from langscenex_tpu_torch.ops.flash_attention import (
        flash_attention_backward_kernel, flash_attention_backward_plain,
        flash_attention_online_kernel)
    rng = np.random.default_rng(29)
    q, do = (_bhtd(rng, B, H, T, cuda, view) for _ in range(2))
    k, v = (_bhtd(rng, B, H, Tk, cuda, view) for _ in range(2))
    o, l2 = flash_attention_online_kernel(q, k, v, 0.125)
    _build.reset_launch_counts()
    got = flash_attention_backward_kernel(q, k, v, o, l2, do, 0.125)
    torch.cuda.synchronize()
    assert _build.launch_counts["flash_attention_backward"] == 1
    ref = flash_attention_backward_plain(q, k, v, o, l2, do, 0.125)
    for name, g, r, n in zip("qkv", got, ref, (T, Tk, Tk)):
        assert g.shape == (B, H, n, 64) and g.dtype == torch.bfloat16
        assert bool(torch.isfinite(g.float()).all()), name
        g, r = g.float(), r.float()
        torch.testing.assert_close(g, r, rtol=2 ** -7,
                                   atol=2 ** -8 * float(r.abs().max()),
                                   msg=f"d{name}")
        rel = float((g - r).pow(2).mean().sqrt() / r.pow(2).mean().sqrt())
        assert rel < 2 ** -9, (name, rel)


@pytest.mark.gpu
def test_unbounded_forward_backward_launches_k9_and_k7(cuda):
    # one flash_attention(bounded_logits=False) forward + backward: exactly
    # one K9 and one K7 launch, nothing else, and the gradients of K7 on
    # K9's (o, l2); flash_attention_h2 runs K11 and refuses inputs that
    # require grad
    from langscenex_tpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_backward_plain, flash_attention_h2,
        flash_attention_online_kernel)
    rng = np.random.default_rng(28)
    q, k, v, do = (_bhtd(rng, 1, 2, n, cuda, False)
                   for n in (150, 90, 90, 150))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    _build.reset_launch_counts()
    o = flash_attention(*leaves)
    o.backward(do)
    torch.cuda.synchronize()
    assert _build.launch_counts == {**{n: 0 for n in _build.launch_counts},
                                    "flash_attention_online": 1,
                                    "flash_attention_backward": 1}
    ro, rl2 = flash_attention_online_kernel(q, k, v, 0.125)
    assert torch.equal(o.detach(), ro)
    ref = flash_attention_backward_plain(q, k, v, ro, rl2, do, 0.125)
    for leaf, r in zip(leaves, ref):
        torch.testing.assert_close(leaf.grad.float(), r.float(),
                                   rtol=2 ** -7,
                                   atol=2 ** -8 * float(r.abs().max()))
    _build.reset_launch_counts()
    assert flash_attention_h2(q, k, v).shape == q.shape
    assert _build.launch_counts["flash_attention_h2"] == 1
    with pytest.raises(ValueError, match="forward only"):
        flash_attention_h2(*leaves)


@pytest.mark.gpu
@pytest.mark.parametrize("H,dtype", [(256, torch.bfloat16),
                                     (3072, torch.bfloat16),
                                     (3072, torch.float32),
                                     (4096, torch.float32)])
def test_ln_modulate_kernel_matches_plain(cuda, H, dtype):
    # K8 against the plain version: the same f32 statistics summed in
    # another order, and n·A + C against (n·γ + β)(1 + s) + shift, so a bf16
    # output may differ by one bf16 ulp: 2^-7 relative + 1e-4; in f32 the
    # two differ by a few f32 roundings of values of order 10: 1e-5
    from langscenex_tpu_torch.ops.ln_modulate import (ln_modulate,
                                                      ln_modulate_plain)
    rng = np.random.default_rng(22)
    B, T = 2, 700

    def t(shape, scale, shift=0.0):
        return torch.from_numpy((rng.normal(size=shape) * scale + shift)
                                .astype(np.float32)).to(cuda, dtype)

    x = t((B, T, H), 2.0, shift=0.5)
    gamma = t((H,), 0.5, shift=1.0)
    beta = t((H,), 0.1)
    mods = [t((B, H), 0.3) for _ in range(4)]
    _build.reset_launch_counts()
    y = ln_modulate(x, gamma, beta, *mods, 226)
    torch.cuda.synchronize()
    assert _build.launch_counts["ln_modulate"] == 1
    ref = ln_modulate_plain(x, gamma, beta, *mods, 226)
    assert y.dtype == dtype and y.shape == x.shape
    tol = (dict(atol=1e-4, rtol=2 ** -7) if dtype == torch.bfloat16
           else dict(atol=1e-5, rtol=1e-5))
    torch.testing.assert_close(y.float(), ref.float(), **tol)
    other = torch.float32 if dtype == torch.bfloat16 else torch.bfloat16
    with pytest.raises(TypeError, match="bf16"):
        ln_modulate(x, gamma.to(other), beta, *mods, 226)


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,T,Tk,view,mag", [(1, 4, 300, 300, False, 1.0),
                                               (2, 3, 130, 200, True, 1.0),
                                               (1, 3, 192, 192, False, 1.0),
                                               (2, 2, 200, 70, True, 1.0),
                                               (1, 1, 1, 1, False, 1.0),
                                               (1, 2, 128, 192, False, 20.0),
                                               *WGMMA_EDGES])
def test_exp2_kernels_match_plain(cuda, B, H, T, Tk, view, mag):
    # K13a and K13b against their plain versions at the kernels' 128-key
    # tile (the same rescale points), Tk != T, tails, views, odd B·H, x20
    # logits and the edges of the wgmma forward's tiling.
    # K13a has K9's rounding points but for l: o within K9's
    # bound, 2^-7 relative + 1e-3. K13b's packed exp is within one bf16
    # ulp of exp2 rounded to bf16 (test_packed_exp2_within_one_ulp), so
    # each p may move by a factor 1 + e, |e| <= 2^-7, and o = sum p v /
    # sum p by 2^-7 / (1 - 2^-7) max|v - o|, plus a bf16 rounding of each
    # side's o; the many moves have either sign, so o's relative RMS
    # difference stays within 2^-7
    from langscenex_tpu_torch.ops.flash_attention import (
        WGMMA_BLOCK_K, flash_attention_exp2_bf16_kernel,
        flash_attention_exp2_bf16_plain, flash_attention_exp2_kernel,
        flash_attention_exp2_plain)
    rng = np.random.default_rng(27)
    q, k, v = _online_inputs(rng, B, H, T, Tk, cuda, view, mag)
    _build.reset_launch_counts()
    o = flash_attention_exp2_kernel(q, k, v, 0.125)
    ob = flash_attention_exp2_bf16_kernel(q, k, v, 0.125)
    torch.cuda.synchronize()
    assert _build.launch_counts == {**{n: 0 for n in _build.launch_counts},
                                    "flash_attention_exp2": 1,
                                    "flash_attention_exp2_bf16": 1}
    ro = flash_attention_exp2_plain(q, k, v, 0.125, block_k=WGMMA_BLOCK_K)
    rb = flash_attention_exp2_bf16_plain(q, k, v, 0.125,
                                         block_k=WGMMA_BLOCK_K).float()
    assert o.shape == ob.shape == (B, H, T, 64)
    assert bool(torch.isfinite(o.float()).all())
    torch.testing.assert_close(o.float(), ro.float(), atol=1e-3,
                               rtol=2 ** -7)
    ob = ob.float()
    assert bool(torch.isfinite(ob).all())
    e = 2 ** -7
    lim = e / (1 - e) * (float(v.abs().max()) + rb.abs()) + e * rb.abs()
    assert bool(((ob - rb).abs() <= lim).all())
    assert float((ob - rb).norm() / rb.norm()) <= 2 ** -7


@pytest.mark.gpu
def test_packed_exp2_within_one_ulp(cuda):
    # K13b's ex2.approx.ftz.bf16x2 alone on every bf16 input of [-126, 0]
    # (the d = s - m of the softmax whose exp is a normal number) against
    # exp2 computed in f32 and rounded to bf16: at most one bf16 ulp apart;
    # below -126 the result is 0 or below 2^-126 (subnormals flush)
    from langscenex_tpu_torch.ops.flash_attention import (exp2_bf16x2_kernel,
                                                          exp2_bf16x2_plain)
    x = torch.arange(-2 ** 15, 2 ** 15, dtype=torch.int32).to(
        torch.int16).view(torch.bfloat16)
    x = x[torch.isfinite(x) & (x <= 0)].to(cuda)
    x = x[:x.numel() // 2 * 2]
    _build.reset_launch_counts()
    got = exp2_bf16x2_kernel(x)
    torch.cuda.synchronize()
    assert _build.launch_counts["exp2_bf16x2"] == 1
    ref = exp2_bf16x2_plain(x)
    normal = x >= -126
    ulps = (got.view(torch.int16).int() - ref.view(torch.int16).int()).abs()
    assert int(ulps[normal].max()) <= 1
    assert bool((got[~normal].float() <= 2.0 ** -126).all())
    with pytest.raises(ValueError, match="n even"):
        exp2_bf16x2_kernel(x[:3])


@pytest.mark.gpu
@pytest.mark.parametrize("W,dtype", [(8, torch.float32), (24, torch.float32),
                                     (128, torch.float32),
                                     (8, torch.bfloat16),
                                     (24, torch.bfloat16),
                                     (128, torch.bfloat16),
                                     (7, torch.float32), (3, torch.bfloat16)])
def test_gather_kernel_matches_plain(cuda, W, dtype):
    # K13c against its plain version bit for bit, rows of whole 16-byte
    # vectors (W 8, 24, 128 in f32 and bf16) and others (W 7, 3), from a
    # contiguous table and from a column slice of a wider one, with
    # indices that wrap (-1, -R) and that fall outside (NaN rows)
    from langscenex_tpu_torch.ops.gather import (gather_rows,
                                                 gather_rows_kernel,
                                                 gather_rows_plain)
    rng = np.random.default_rng(28)
    R, A = 1000, 2048
    wide = torch.from_numpy(rng.normal(size=(R, W + 5)).astype(
        np.float32)).to(cuda, dtype)
    idx = rng.integers(0, R, A).astype(np.int32)
    idx[:6] = [-1, -R, -R - 1, R, R - 1, 2 ** 31 - 1]
    idx = torch.from_numpy(idx).to(cuda)
    bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    _build.reset_launch_counts()
    for tab in (wide[:, :W].contiguous(), wide[:, :W]):
        got = gather_rows_kernel(tab, idx)
        torch.cuda.synchronize()
        want = gather_rows_plain(tab, idx)
        assert got.shape == (A, W) and got.dtype == dtype
        assert torch.equal(got.view(bits), want.view(bits))
        assert bool(got[[2, 3, 5]].isnan().all())
    assert gather_rows(wide[:, :W], idx).shape == (A // 512, 512, W)
    assert _build.launch_counts == {**{n: 0 for n in _build.launch_counts},
                                    "gather_rows": 3}
