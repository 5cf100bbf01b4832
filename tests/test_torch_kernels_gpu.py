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
    from langscenex_tpu_torch.ops.flash_attention import attention_bthd
    from langscenex_tpu_torch.ops.ln_modulate import ln_modulate
    x = torch.empty(1, 4, 2, 64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        attention_bthd(x, x, x)
    m = torch.empty(1, 8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ln_modulate(torch.empty(1, 4, 8, device="meta"), m[0], m[0], m, m, m,
                    m, 2)


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
