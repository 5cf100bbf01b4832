"""The hand-written CUDA kernels against their plain PyTorch versions on a
CUDA device. This file imports torch only (no JAX), so it also runs on a
machine without JAX:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_kernels_gpu.py

Without a CUDA device the ``gpu`` cases skip (a CUDA kernel has no CPU
mode); the device contract of the wrappers is checked on any machine."""
import dataclasses
import math

import numpy as np
import pytest
import torch

from langscenex_tpu_torch.convert import raster_camera_from_numpy
from langscenex_tpu_torch.ops.compaction import (compact_pairs,
                                                 compact_pairs_plain)
from langscenex_tpu_torch.ops.rasterize import RasterConfig, rasterize
from langscenex_tpu_torch import _build
from langscenex_tpu_torch.ops.rasterize import prepare_blend
from langscenex_tpu_torch.ops.rasterize_cuda import (blend_backward,
                                                     blend_backward_plain,
                                                     blend_tiles)
from langscenex_tpu_torch.ops.sort_engine import sort_pairs, sort_pairs_plain
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


@pytest.mark.gpu
def test_sort_kernel_matches_plain(cuda):
    rng = np.random.default_rng(5)
    for n in (1, 2047, 2048, 100_003):
        key = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31 - 1, n)
                               .astype(np.int32)).to(cuda)
        key[: n // 3] = 7                             # ties
        val = torch.arange(n, dtype=torch.int32, device=cuda)
        got, ref = sort_pairs(key, val), sort_pairs_plain(key, val)
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
                                        (False, (128, 8))])
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
