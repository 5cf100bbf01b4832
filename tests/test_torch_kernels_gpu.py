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
from langscenex_tpu_torch.ops.rasterize_cuda import blend_tiles
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
