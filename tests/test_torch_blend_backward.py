"""The blend backward of the PyTorch port (the plain version of kernel K2,
what the CUDA kernel is held against on the card) vs the JAX package's
custom VJP of ``blend_tiles_pallas`` (the TPU kernel ``_bwd_kernel`` in
interpret mode, CPU), including the exact abs-gradient hook; and vs torch
autograd through the plain forward, an independent derivation."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_threads import few_torch_threads  # noqa: F401
from jax.experimental.pallas import tpu as pltpu

from langscenex_tpu.ops import transforms as jtf
from langscenex_tpu.ops.binning import build_tile_lists as jax_build
from langscenex_tpu.ops.projection import RasterCamera as JCam
from langscenex_tpu.ops.projection import preprocess as jax_preprocess
from langscenex_tpu.ops.rasterize import RasterConfig as JConfig
from langscenex_tpu.ops.rasterize_pallas import blend_tiles_pallas
from langscenex_tpu_torch.ops.binning import TileLists
from langscenex_tpu_torch.ops.rasterize import RasterConfig
from langscenex_tpu_torch.ops.rasterize_cuda import (blend_backward_plain,
                                                     blend_tiles,
                                                     blend_tiles_plain)

W, H = 256, 32          # 2x4 grid of 128x8 tiles
GX, GY = 2, 4
C = 14


def _scene(P, seed, opac_kind):
    rng = np.random.default_rng(seed)
    means = np.stack([rng.uniform(-2, 2, P), rng.uniform(-0.3, 0.3, P),
                      rng.uniform(2, 8, P)], -1).astype(np.float32)
    scales = np.exp(rng.uniform(-3.5, -1.5, (P, 3))).astype(np.float32)
    quats = rng.normal(size=(P, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    opac = {"sparse": rng.uniform(0.2, 0.95, P),
            "dense": np.full(P, 0.97),
            "clamp": np.full(P, 1.0)}[opac_kind].astype(np.float32)
    colors = rng.uniform(0, 1, (P, C)).astype(np.float32)
    weights = rng.normal(size=(GX * GY, C, 1024)).astype(np.float32)
    t_weights = rng.normal(size=(GX * GY, 1024)).astype(np.float32)
    return means, scales, quats, opac, colors, weights, t_weights


def _cam():
    fovy = jtf.focal2fov(jtf.fov2focal(1.0, W), H)
    return JCam(w2c=jnp.eye(4),
                proj=jnp.asarray(jtf.projection_matrix(0.01, 100, 1.0, fovy)),
                width=W, height=H, tan_fovx=float(np.tan(0.5)),
                tan_fovy=float(np.tan(fovy / 2)))


@functools.partial(jax.jit, static_argnums=(4,))
def _jax_lists(means, scales, quats, opac, max_pairs):
    proc = jax_preprocess(means, scales, quats, _cam(), tile_w=128,
                          tile_h=8, colors_precomp=means)
    lists = jax_build(proc, GX, GY, 8, max_pairs=max_pairs, big_splats=64)
    return proc, lists, jnp.where(proc.visible, opac, 0.0)


def _jax_grads(lists, mean2d, conic, op, colors, weights, t_weights):
    cfg = JConfig(tile_w=128, tile_h=8, max_pairs=lists.point_list.shape[0])

    def loss(m, co, o, ch, hook):
        accum, T, _ = blend_tiles_pallas(lists, m, co, o, ch, GX, GY, cfg,
                                         mean2d_abs_hook=hook)
        return jnp.sum(accum * weights) + jnp.sum(T * t_weights)

    with pltpu.force_tpu_interpret_mode():
        return jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3, 4)))(
            mean2d, conic, op, colors, jnp.zeros_like(mean2d))


def _t(a):
    return torch.from_numpy(np.array(a))


def _torch_grads(lists, mean2d, conic, op, colors, weights, t_weights,
                 chunk=128):
    tl = TileLists(*(_t(x) for x in lists[:7]))
    leaves = [_t(x).requires_grad_() for x in (mean2d, conic, op, colors)]
    hook = torch.zeros(leaves[0].shape, requires_grad=True)
    accum, T, _ = blend_tiles(tl, *leaves, GX, GY,
                              RasterConfig(tile_w=128, tile_h=8, chunk=chunk),
                              mean2d_abs_hook=hook)
    loss = (accum * _t(weights)).sum() + (T * _t(t_weights)).sum()
    return torch.autograd.grad(loss, leaves + [hook])


# case -> (points, seed, opacity, max_pairs): "sparse" leaves budget to
# spare, so the list tail holds sentinel pairs (sid P); "budget" caps the
# list below its demand, so trailing splats' pairs are dropped
CASES = {"sparse": (160, 3, "sparse", 1500), "dense": (400, 4, "dense", None),
         "clamp": (160, 5, "clamp", None), "budget": (400, 6, "sparse", 600)}
NAMES = ("mean2d", "conic", "opacity", "channels", "abs_hook")


@pytest.mark.parametrize("case", list(CASES))
def test_plain_backward_matches_pallas_vjp(case):
    P, seed, opac_kind, max_pairs = CASES[case]
    means, scales, quats, opac, colors, wts, twts = _scene(P, seed, opac_kind)
    proc, lists, op = _jax_lists(*map(jnp.asarray, (means, scales, quats,
                                                    opac)), max_pairs)
    if case == "budget":
        assert bool(lists.overflowed)
    if case == "sparse":
        assert int(np.asarray(lists.point_list == P).sum()) > 0
    if case == "clamp":
        # some pairs sit on the 0.99 alpha clamp, where d/dpower is zero
        assert float(jnp.max(op)) == 1.0
    args = (proc.mean2d, proc.conic, op, jnp.asarray(colors),
            jnp.asarray(wts), jnp.asarray(twts))
    jg = _jax_grads(lists, *args)
    tg = _torch_grads(lists, *map(np.asarray, args))
    # Pallas vs plain round differently (tile-centre vs global pixel
    # coordinates, roll-add vs cumsum prefix): the JAX package's own
    # Pallas-vs-XLA gradient bounds, 2e-3 of each array's largest
    # magnitude + 5e-3 relative. Under dense occlusion one pair may flip
    # at the T < 1e-4 stop at a pixel; there the bound holds for all but
    # 2% of splats.
    for a, b, nm in zip(jg, tg, NAMES):
        a, b = np.asarray(a), b.numpy()
        assert np.isfinite(b).all(), nm
        scale = max(np.abs(a).max(), 1e-3)
        bad = np.abs(b - a) > 2e-3 * scale + 5e-3 * np.abs(a)
        bad = bad.reshape(bad.shape[0], -1).any(1)
        assert bad.mean() <= (0.02 if case == "dense" else 0.0), (
            nm, bad.mean(), np.abs(b - a).max(), scale)
    g_signed, g_abs = tg[0].numpy(), tg[4].numpy()
    assert (g_abs >= 0).all()
    assert (np.abs(g_signed) <= g_abs + 1e-4 * np.abs(g_abs).max()).all()
    assert (g_abs > np.abs(g_signed) + 1e-5).any()       # cancellation


@pytest.mark.parametrize("chunk", [16, 128])
def test_plain_backward_matches_autograd_of_plain_forward(chunk):
    # an independent derivation: torch autograd through the plain forward
    # (whose every op is differentiable) on the same lists, in f32; the
    # hand backward forms the suffix as total - prefix, so the two differ
    # by f32 cancellation only (1e-4 of each array's largest magnitude)
    means, scales, quats, opac, colors, wts, twts = _scene(300, 7, "dense")
    proc, lists, op = _jax_lists(*map(jnp.asarray, (means, scales, quats,
                                                    opac)), None)
    tl = TileLists(*(_t(x) for x in lists[:7]))
    ins = [_t(x) for x in (proc.mean2d, proc.conic, op, colors)]
    leaves = [x.clone().requires_grad_() for x in ins]
    accum, T, _ = blend_tiles_plain(tl, *leaves, GX, GY, 128, 8, chunk)
    ref = torch.autograd.grad((accum * _t(wts)).sum() + (T * _t(twts)).sum(),
                              leaves)
    with torch.no_grad():
        accum, T, _ = blend_tiles_plain(tl, *ins, GX, GY, 128, 8, chunk)
        got = blend_backward_plain(tl, *ins, accum, T, _t(wts), _t(twts), GX,
                                   GY, 128, 8, chunk)
    assert int(np.asarray(lists.tile_counts).max()) > chunk
    cols = (got[:, 0:2], got[:, 2:5], got[:, 5], got[:, 6:6 + C])
    for a, b, nm in zip(ref, cols, NAMES):
        scale = float(a.abs().max())
        assert float((a - b).abs().max()) <= 1e-4 * scale, nm
