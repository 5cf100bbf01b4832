"""PyTorch port vs the JAX package: quat, transforms, SH, covariance and
preprocess, on the same numpy inputs (CPU, float32)."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_threads import few_torch_threads  # noqa: F401

from langscenex_tpu.ops import covariance as jcov
from langscenex_tpu.ops import projection as jproj
from langscenex_tpu.ops import quat as jq
from langscenex_tpu.ops import sh as jsh
from langscenex_tpu.ops import transforms as jtf
from langscenex_tpu_torch.ops import covariance as tcov
from langscenex_tpu_torch.ops import projection as tproj
from langscenex_tpu_torch.ops import quat as tq
from langscenex_tpu_torch.ops import sh as tsh
from langscenex_tpu_torch.ops import transforms as ttf

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# Elementwise float32 formulas in the same operation order: results differ
# only where XLA contracts a multiply-add into an FMA, a few ulp.
ELEM_ATOL = 1e-6


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(a_jax, b_torch, **kw):
    np.testing.assert_allclose(b_torch.detach().numpy(), np.asarray(a_jax),
                               **kw)


def _quats(rng, n):
    q = rng.normal(size=(n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def test_quat_ops_match_jax():
    rng = np.random.default_rng(0)
    q1 = rng.normal(size=(64, 4)).astype(np.float32)   # not normalized
    q2 = _quats(rng, 64)
    qt = np.concatenate([q1, rng.normal(size=(64, 3))], -1).astype(np.float32)
    _close(jq.quat_normalize(jnp.asarray(q1)), tq.quat_normalize(_t(q1)),
           atol=ELEM_ATOL)
    _close(jq.quat_to_rotmat(jnp.asarray(q2)), tq.quat_to_rotmat(_t(q2)),
           atol=ELEM_ATOL)
    _close(jq.quat_multiply(jnp.asarray(q1), jnp.asarray(q2)),
           tq.quat_multiply(_t(q1), _t(q2)), atol=1e-5)
    _close(jq.camera_from_tensor(jnp.asarray(qt)),
           tq.camera_from_tensor(_t(qt)), atol=ELEM_ATOL)


def test_transforms_match_jax():
    rng = np.random.default_rng(1)
    # host-side numpy code, copied: identical bits
    np.testing.assert_array_equal(
        ttf.projection_matrix(0.01, 100.0, 1.1, 0.7),
        jtf.projection_matrix(0.01, 100.0, 1.1, 0.7))
    assert ttf.fov2focal(1.0, 720) == jtf.fov2focal(1.0, 720)
    assert ttf.focal2fov(600.0, 480) == jtf.focal2fov(600.0, 480)
    R = np.asarray(jq.quat_to_rotmat(jnp.asarray(_quats(rng, 1)[0])),
                   np.float64)
    t = rng.normal(size=3)
    np.testing.assert_array_equal(
        ttf.world_to_view(R, t, (0.1, -0.2, 0.3), 1.5),
        jtf.world_to_view(R, t, (0.1, -0.2, 0.3), 1.5))
    v = rng.uniform(-1.5, 1.5, 256).astype(np.float32)
    _close(jtf.ndc_to_pix(jnp.asarray(v), 720), ttf.ndc_to_pix(_t(v), 720),
           rtol=1e-6, atol=1e-4)


@pytest.mark.parametrize("deg", [0, 1, 2, 3])
def test_sh_matches_jax(deg):
    rng = np.random.default_rng(2 + deg)
    d = rng.normal(size=(3, 128)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    shs = rng.normal(size=(128, 16, 3)).astype(np.float32)
    jb = jsh.sh_basis(deg, *map(jnp.asarray, d))
    tb = tsh.sh_basis(deg, *map(_t, d))
    assert len(jb) == len(tb) == (deg + 1) ** 2
    for a, b in zip(jb, tb):
        _close(a, b, atol=ELEM_ATOL)
    _close(jsh.sh_to_rgb_fast(deg, jnp.asarray(shs), *map(jnp.asarray, d)),
           tsh.sh_to_rgb_fast(deg, _t(shs), *map(_t, d)), atol=1e-5)
    rgb = rng.uniform(0, 1, (16, 3)).astype(np.float32)
    _close(jsh.rgb_to_sh(jnp.asarray(rgb)), tsh.rgb_to_sh(_t(rgb)),
           atol=ELEM_ATOL)


def _cam_np(W, H, yaw_deg=0.0, t=(0.0, 0.0, 0.0), fovx=1.0):
    fovy = jtf.focal2fov(jtf.fov2focal(fovx, W), H)
    c, s = math.cos(math.radians(yaw_deg)), math.sin(math.radians(yaw_deg))
    w2c = np.eye(4, dtype=np.float32)
    w2c[:3, :3] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
    w2c[:3, 3] = t
    proj = jtf.projection_matrix(0.01, 100.0, fovx, fovy)
    return w2c, proj, math.tan(fovx / 2), math.tan(fovy / 2)


def _scene(P, seed):
    rng = np.random.default_rng(seed)
    means = np.stack([rng.uniform(-2.5, 2.5, P), rng.uniform(-1.5, 1.5, P),
                      rng.uniform(-0.5, 8, P)], -1).astype(np.float32)
    scales = np.exp(rng.uniform(-4, -1.5, (P, 3))).astype(np.float32)
    quats = _quats(rng, P)
    opac = rng.uniform(0.001, 0.95, P).astype(np.float32)
    shs = (0.3 * rng.normal(size=(P, 16, 3))).astype(np.float32)
    return means, scales, quats, opac, shs


def test_covariance_matches_jax():
    means, scales, quats, opac, _ = _scene(500, 5)
    w2c, proj, tx, ty = _cam_np(256, 160, yaw_deg=7.0, t=(0.1, 0.0, 0.3))
    fx, fy = 256 / (2 * tx), 160 / (2 * ty)
    j3 = jcov.compute_cov3d(jnp.asarray(scales), jnp.asarray(quats), 1.2)
    t3 = tcov.compute_cov3d(_t(scales), _t(quats), 1.2)
    _close(j3, t3, rtol=1e-5, atol=1e-9)
    j2 = jcov.compute_cov2d(jnp.asarray(means), j3, jnp.asarray(w2c),
                            fx, fy, tx, ty)
    t2 = tcov.compute_cov2d(_t(means), t3, _t(w2c), fx, fy, tx, ty)
    _close(j2, t2, rtol=1e-4, atol=1e-5)
    # same cov2d on both sides: the inversion itself is compared
    jc, jr, jv, jrb = jcov.conic_and_radius(j2, jnp.asarray(opac))
    tc, tr, tv, trb = tcov.conic_and_radius(_t(np.asarray(j2)), _t(opac))
    _close(jc, tc, rtol=1e-5, atol=1e-7)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    # ceil() of sqrt/log values: exact on a generic scene
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(trb.numpy(), np.asarray(jrb))
    jc0, jr0, _ = jcov.conic_and_radius(j2)
    tc0, tr0, _ = tcov.conic_and_radius(_t(np.asarray(j2)))
    np.testing.assert_array_equal(tr0.numpy(), np.asarray(jr0))


@pytest.mark.parametrize("opacity_aware,use_sh", [(True, True), (False, True),
                                                  (True, False)])
def test_preprocess_matches_jax(opacity_aware, use_sh):
    W, H = 256, 160
    means, scales, quats, opac, shs = _scene(1500, 6)
    w2c, proj, tx, ty = _cam_np(W, H, yaw_deg=-4.0, t=(0.05, -0.1, 0.2))
    colors = np.abs(shs[:, 0])
    jcam = jproj.RasterCamera(w2c=jnp.asarray(w2c), proj=jnp.asarray(proj),
                              width=W, height=H, tan_fovx=tx, tan_fovy=ty)
    tcam = tproj.RasterCamera(w2c=_t(w2c), proj=_t(proj), width=W, height=H,
                              tan_fovx=tx, tan_fovy=ty)
    kw_j = dict(tile_w=32, tile_h=32)
    if use_sh:
        kw_j.update(shs=jnp.asarray(shs), sh_degree=3)
        kw_t = dict(shs=_t(shs), sh_degree=3)
    else:
        kw_j.update(colors_precomp=jnp.asarray(colors))
        kw_t = dict(colors_precomp=_t(colors))
    if opacity_aware:
        kw_j["opacity"] = jnp.asarray(opac)
        kw_t["opacity"] = _t(opac)
    a = jproj.preprocess(jnp.asarray(means), jnp.asarray(scales),
                         jnp.asarray(quats), jcam, **kw_j)
    b = tproj.preprocess(_t(means), _t(scales), _t(quats), tcam,
                         tile_w=32, tile_h=32, **kw_t)
    vis = np.asarray(a.visible)
    assert vis.sum() > 500 and (~vis).sum() > 50     # both branches used
    # pixel means ~1e2-1e3 px: a few f32 ulp of the projection product
    _close(a.mean2d, b.mean2d, rtol=1e-5, atol=1e-3)
    _close(a.depth, b.depth, rtol=1e-6, atol=1e-6)
    _close(a.rgb, b.rgb, atol=1e-5)
    np.testing.assert_allclose(b.conic.numpy()[vis], np.asarray(a.conic)[vis],
                               rtol=1e-3, atol=1e-6)
    # integer and discrete outputs: exact
    for f in ("radius", "visible", "rect_min", "rect_max", "tiles_touched"):
        np.testing.assert_array_equal(getattr(b, f).numpy(),
                                      np.asarray(getattr(a, f)), err_msg=f)
    assert b.rect_min.dtype == torch.int32
    assert b.tiles_touched.dtype == torch.int32
