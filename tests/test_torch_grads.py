"""Gradients of the PyTorch port vs ``jax.grad`` of the JAX package (CPU,
float32): the math core (quat, covariance, SH, preprocess), the pose
tensor conversion, the full ``rasterize`` (JAX side with the Pallas
blend in interpret mode) and ``render_view`` in both pose modes. Each
loss is a fixed random weighting of the outputs, made with numpy."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_threads import few_torch_threads  # noqa: F401
from jax.experimental.pallas import tpu as pltpu

from langscenex_tpu.ops import covariance as jcov
from langscenex_tpu.ops import projection as jproj
from langscenex_tpu.ops import quat as jq
from langscenex_tpu.ops import sh as jsh
from langscenex_tpu.ops import transforms as jtf
from langscenex_tpu.ops.rasterize import RasterConfig as JConfig
from langscenex_tpu.ops.rasterize import rasterize as jax_rasterize
from langscenex_tpu.scene.gaussians import GaussianState as JState
from langscenex_tpu.train.field import render_view as jax_render_view
from langscenex_tpu_torch import convert
from langscenex_tpu_torch.ops import covariance as tcov
from langscenex_tpu_torch.ops import projection as tproj
from langscenex_tpu_torch.ops import quat as tq
from langscenex_tpu_torch.ops import sh as tsh
from langscenex_tpu_torch.ops.rasterize import RasterConfig, rasterize
from langscenex_tpu_torch.scene.gaussians import GaussianState
from langscenex_tpu_torch.train.field import render_view

W, H = 128, 64                       # 4x2 grid of 32x32 tiles
FOVX = 1.0
FOVY = jtf.focal2fov(jtf.fov2focal(FOVX, W), H)
PROJ = jtf.projection_matrix(0.01, 100.0, FOVX, FOVY)
TANX, TANY = math.tan(FOVX / 2), math.tan(FOVY / 2)


def _t(a):
    return torch.from_numpy(np.array(a))


def _check(jg, tg, names, atol_frac, rtol, max_bad=0.0):
    """Each torch gradient against JAX's: within atol_frac of the array's
    largest magnitude plus rtol relative, for all but ``max_bad`` of the
    rows."""
    for a, b, nm in zip(jg, tg, names):
        a, b = np.asarray(a), b.detach().numpy()
        assert a.shape == b.shape, nm
        assert np.isfinite(b).all(), nm
        scale = max(np.abs(a).max(), 1e-6)
        bad = np.abs(b - a) > atol_frac * scale + rtol * np.abs(a)
        bad = bad.reshape(bad.shape[0], -1).any(1) if bad.ndim else bad
        assert np.mean(bad) <= max_bad, (nm, np.mean(bad),
                                         np.abs(b - a).max(), scale)


# ---------------------------------------------------------------- math core

def _quats(rng, n):
    q = rng.normal(size=(n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _rotmats(rng, n):
    """Proper rotations spread over all four Shepperd branches."""
    q = _quats(rng, n)
    q[: n // 4, 0] *= 10.0                     # w pivot
    q[n // 4: n // 2, 1] *= 10.0               # x pivot
    q[n // 2: 3 * n // 4, 2] *= 10.0           # y pivot
    q[3 * n // 4:, 3] *= 10.0                  # z pivot
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    return np.asarray(jq.quat_to_rotmat(jnp.asarray(q)))


def _math_case(name, rng):
    """(jax fn, torch fn, numpy inputs) for one math-core function."""
    n = 64
    if name == "quat_normalize":
        return jq.quat_normalize, tq.quat_normalize, (
            rng.normal(size=(n, 4)).astype(np.float32),)
    if name == "quat_to_rotmat":
        return jq.quat_to_rotmat, tq.quat_to_rotmat, (_quats(rng, n),)
    if name == "quat_multiply":
        return jq.quat_multiply, tq.quat_multiply, (
            rng.normal(size=(n, 4)).astype(np.float32), _quats(rng, n))
    if name == "camera_from_tensor":
        return jq.camera_from_tensor, tq.camera_from_tensor, (
            rng.normal(size=(n, 7)).astype(np.float32),)
    if name == "tensor_from_camera":
        RT = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
        RT[:, :3, :3] = _rotmats(rng, n)
        RT[:, :3, 3] = rng.normal(size=(n, 3))
        return jq.tensor_from_camera, tq.tensor_from_camera, (RT,)
    if name == "cov3d":
        return (lambda s, q: jcov.compute_cov3d(s, q, 1.1),
                lambda s, q: tcov.compute_cov3d(s, q, 1.1),
                (np.exp(rng.uniform(-3, -1, (n, 3))).astype(np.float32),
                 _quats(rng, n)))
    if name == "cov2d":
        w2c = np.eye(4, dtype=np.float32)
        w2c[:3, 3] = (0.1, -0.05, 0.3)
        fx, fy = W / (2 * TANX), H / (2 * TANY)
        means = np.stack([rng.uniform(-1, 1, n), rng.uniform(-0.5, 0.5, n),
                          rng.uniform(2, 6, n)], -1).astype(np.float32)
        cov = np.asarray(jcov.compute_cov3d(
            jnp.asarray(np.exp(rng.uniform(-3, -1, (n, 3))), jnp.float32),
            jnp.asarray(_quats(rng, n))))
        return (lambda m, c: jcov.compute_cov2d(m, c, jnp.asarray(w2c), fx,
                                                fy, TANX, TANY),
                lambda m, c: tcov.compute_cov2d(m, c, _t(w2c), fx, fy, TANX,
                                                TANY), (means, cov))
    if name == "conic":
        a = rng.uniform(1, 5, n)
        c = rng.uniform(1, 5, n)
        b = rng.uniform(-0.5, 0.5, n) * np.sqrt(a * c)
        cov2d = np.stack([a, b, c], -1).astype(np.float32)
        return (lambda x: jcov.conic_and_radius(x)[0],
                lambda x: tcov.conic_and_radius(x)[0], (cov2d,))
    if name == "sh":
        d = rng.normal(size=(n, 3)).astype(np.float32)
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        shs = (0.3 * rng.normal(size=(n, 16, 3))).astype(np.float32)
        return (lambda s, v: jsh.sh_to_rgb_fast(3, s, v[:, 0], v[:, 1],
                                                v[:, 2]),
                lambda s, v: tsh.sh_to_rgb_fast(3, s, v[:, 0], v[:, 1],
                                                v[:, 2]), (shs, d))
    raise KeyError(name)


MATH = ("quat_normalize", "quat_to_rotmat", "quat_multiply",
        "camera_from_tensor", "tensor_from_camera", "cov3d", "cov2d",
        "conic", "sh")


@pytest.mark.parametrize("name", MATH)
def test_math_core_values_and_grads_match_jax(name):
    rng = np.random.default_rng(MATH.index(name))
    jf, tf, ins = _math_case(name, rng)
    out_j = jf(*map(jnp.asarray, ins))
    wts = rng.normal(size=out_j.shape).astype(np.float32)
    leaves = [_t(x).requires_grad_() for x in ins]
    out_t = tf(*leaves)
    # elementwise f32 formulas in the same order: a few ulp (XLA contracts
    # some multiply-adds into FMAs)
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j),
                               rtol=1e-5, atol=1e-5)
    jg = jax.jit(jax.grad(lambda *a: jnp.sum(jf(*a) * wts),
                          argnums=tuple(range(len(ins)))))(
        *map(jnp.asarray, ins))
    tg = torch.autograd.grad((out_t * _t(wts)).sum(), leaves)
    _check(jg, tg, [f"{name}[{i}]" for i in range(len(ins))], 1e-5, 1e-4)


def test_preprocess_grads_match_jax():
    rng = np.random.default_rng(20)
    P = 400
    means = np.stack([rng.uniform(-1.2, 1.2, P), rng.uniform(-0.6, 0.6, P),
                      rng.uniform(2, 6, P)], -1).astype(np.float32)
    scales = np.exp(rng.uniform(-3.5, -1.8, (P, 3))).astype(np.float32)
    quats = _quats(rng, P)
    shs = (0.3 * rng.normal(size=(P, 16, 3))).astype(np.float32)
    off = np.zeros((P, 2), np.float32)
    w2c = np.eye(4, dtype=np.float32)
    w2c[:3, 3] = (0.05, 0.02, 0.1)
    jcam = jproj.RasterCamera(w2c=jnp.asarray(w2c), proj=jnp.asarray(PROJ),
                              width=W, height=H, tan_fovx=TANX, tan_fovy=TANY)
    tcam = convert.raster_camera_from_numpy(w2c, PROJ, W, H, TANX, TANY)
    ins = (means, scales, quats, shs, off)
    vis = np.asarray(jproj.preprocess(*map(jnp.asarray, ins[:3]), jcam,
                                      shs=jnp.asarray(shs), sh_degree=3,
                                      tile_w=32, tile_h=32).visible)
    wm = rng.normal(size=(P, 2)).astype(np.float32) * vis[:, None]
    wc = rng.normal(size=(P, 3)).astype(np.float32) * vis[:, None]
    wr = rng.normal(size=(P, 3)).astype(np.float32)

    def jloss(m, s, q, sh, o):
        p = jproj.preprocess(m, s, q, jcam, shs=sh, sh_degree=3, tile_w=32,
                             tile_h=32, mean2d_offset=o)
        return (jnp.sum(p.mean2d * wm) + jnp.sum(p.conic * wc * 100.0)
                + jnp.sum(p.rgb * wr))

    jg = jax.jit(jax.grad(jloss, argnums=(0, 1, 2, 3, 4)))(
        *map(jnp.asarray, ins))
    leaves = [_t(x).requires_grad_() for x in ins]
    p = tproj.preprocess(*leaves[:3], tcam, shs=leaves[3], sh_degree=3,
                         tile_w=32, tile_h=32, mean2d_offset=leaves[4])
    loss = ((p.mean2d * _t(wm)).sum() + (p.conic * _t(wc) * 100.0).sum()
            + (p.rgb * _t(wr)).sum())
    tg = torch.autograd.grad(loss, leaves)
    _check(jg, tg, ("means", "scales", "quats", "shs", "mean2d_offset"),
           1e-4, 1e-3)


# ---------------------------------------------------- rasterize + render

def _scene(P, seed):
    rng = np.random.default_rng(seed)
    means = np.stack([rng.uniform(-1.2, 1.2, P), rng.uniform(-0.6, 0.6, P),
                      rng.uniform(2, 6, P)], -1).astype(np.float32)
    scales = np.exp(rng.uniform(-3.5, -1.8, (P, 3))).astype(np.float32)
    quats = _quats(rng, P)
    opac = rng.uniform(0.2, 0.95, P).astype(np.float32)
    shs = (0.4 * rng.normal(size=(P, 16, 3))).astype(np.float32)
    feats = rng.uniform(-1, 1, (P, 11)).astype(np.float32)
    return rng, means, scales, quats, opac, shs, feats


# the JAX blend through the Pallas kernel (interpret mode) and the port's
# plain path; both take the exact-config binning at test size
CFG = dict(tile_w=32, tile_h=32, max_tiles_per_splat=4, chunk=128,
           max_splats_per_tile=1024, big_splats=16, extra_tiers=((128, 4),),
           rank_key_sort=True, max_pairs=4000)
OUT_NAMES = ("color", "language", "instance", "all_map", "final_T")
# gradients through preprocess + the blend: the bounds of the JAX
# package's Pallas-vs-XLA gradient test (2e-3 of the largest magnitude +
# 5e-3 relative); a pair at the 1/255 gate or the T < 1e-4 stop may flip
# at a pixel, so 2% of splats may fall outside
GRAD_TOL = dict(atol_frac=2e-3, rtol=5e-3, max_bad=0.02)


def test_rasterize_grads_match_jax():
    rng, means, scales, quats, opac, shs, feats = _scene(300, 21)
    lang, inst = feats[:, :3], feats[:, 3:6]
    amap = np.concatenate([feats[:, 6:9], np.ones((300, 1)),
                           feats[:, 9:10] + 3.0], 1).astype(np.float32)
    jcam = jproj.RasterCamera(w2c=jnp.eye(4), proj=jnp.asarray(PROJ),
                              width=W, height=H, tan_fovx=TANX, tan_fovy=TANY)
    bg = np.array([0.1, 0.2, 0.3], np.float32)
    ins = (means, scales, quats, opac, shs, lang, inst, amap)
    cfg = JConfig(use_pallas=True, **CFG)

    def jrender(m, s, q, o, sh, la, ins_, am):
        return jax_rasterize(m, s, q, o, jcam, jnp.asarray(bg), shs=sh,
                             sh_degree=3, language_feature=la,
                             instance_feature=ins_, all_map=am, cfg=cfg)

    with pltpu.force_tpu_interpret_mode():
        out = jax.jit(jrender)(*map(jnp.asarray, ins))
    wts = {k: rng.normal(size=np.shape(getattr(out, k))).astype(np.float32)
           for k in OUT_NAMES}

    def jloss(*a):
        o = jrender(*a)
        return sum(jnp.sum(getattr(o, k) * w) for k, w in wts.items())

    with pltpu.force_tpu_interpret_mode():
        jg = jax.jit(jax.grad(jloss, argnums=tuple(range(8))))(
            *map(jnp.asarray, ins))
    leaves = [_t(x).requires_grad_() for x in ins]
    o = rasterize(*leaves[:4], convert.raster_camera_from_numpy(
        np.eye(4), PROJ, W, H, TANX, TANY), _t(bg), shs=leaves[4],
        sh_degree=3, language_feature=leaves[5], instance_feature=leaves[6],
        all_map=leaves[7], cfg=RasterConfig(**CFG))
    assert not bool(o.pairs_overflowed) and int(o.num_pairs) > 400
    loss = sum((getattr(o, k) * _t(w)).sum() for k, w in wts.items())
    tg = torch.autograd.grad(loss, leaves)
    _check(jg, tg, ("means", "scales", "quats", "opacity", "shs",
                    "language", "instance", "all_map"), **GRAD_TOL)


def _state_numpy(P, seed):
    _, means, scales, quats, opac, shs, feats = _scene(P, seed)
    alive = np.ones(P, bool)
    alive[-P // 10:] = False
    return dict(xyz=means, knn_f=np.zeros((P, 6), np.float32),
                features_dc=shs[:, :1].copy(),
                features_rest=shs[:, 1:].copy(), scaling=np.log(scales),
                rotation=quats * 1.7, opacity=np.log(opac / (1 - opac))[:, None],
                language_feature=feats[:, :3].copy(),
                instance_feature=feats[:, 3:6].copy(), alive=alive)


PARAMS = ("xyz", "features_dc", "features_rest", "scaling", "rotation",
          "opacity", "language_feature", "instance_feature")


@pytest.mark.parametrize("pose_mode", [False, True])
def test_render_view_grads_match_jax(pose_mode):
    d = _state_numpy(300, 22)
    rng = np.random.default_rng(23)
    a = math.radians(2.0)
    w2c = np.eye(4, dtype=np.float32)
    w2c[:3, :3] = [[math.cos(a), 0, math.sin(a)], [0, 1, 0],
                   [-math.sin(a), 0, math.cos(a)]]
    w2c[:3, 3] = (0.05, -0.02, 0.1)
    pose = np.array([0.999, 0.02, -0.03, 0.01, 0.1, -0.05, 0.2], np.float32)
    jcam = jproj.RasterCamera(w2c=jnp.eye(4), proj=jnp.asarray(PROJ),
                              width=W, height=H, tan_fovx=TANX, tan_fovy=TANY)
    cfg = JConfig(use_pallas=True, **CFG)
    alive = jnp.asarray(d["alive"])

    def jrender(params, p):
        s = JState(alive=alive, **params)
        return jax_render_view(s, p if pose_mode else None,
                               jnp.asarray(w2c), jcam, jnp.zeros(3), 3,
                               True, True, None, cfg)

    jparams = {k: jnp.asarray(d[k]) for k in PARAMS + ("knn_f",)}
    with pltpu.force_tpu_interpret_mode():
        out = jax.jit(jrender)(jparams, jnp.asarray(pose))
    wts = {k: rng.normal(size=np.shape(getattr(out, k))).astype(np.float32)
           for k in OUT_NAMES}

    def jloss(params, p):
        o = jrender(params, p)
        return sum(jnp.sum(getattr(o, k) * w) for k, w in wts.items())

    with pltpu.force_tpu_interpret_mode():
        jgp, jgpose = jax.jit(jax.grad(jloss, argnums=(0, 1)))(
            jparams, jnp.asarray(pose))
    tstate = convert.gaussian_state_from_numpy(d)
    leaves = {k: getattr(tstate, k).clone().requires_grad_()
              for k in PARAMS}
    tpose = _t(pose).requires_grad_()
    s = GaussianState(**{**tstate.__dict__, **leaves})
    o = render_view(s, tpose if pose_mode else None, _t(w2c),
                    convert.raster_camera_from_numpy(np.eye(4), PROJ, W, H,
                                                     TANX, TANY),
                    torch.zeros(3), 3, True, True, None, RasterConfig(**CFG))
    assert int(o.num_pairs) > 400
    loss = sum((getattr(o, k) * _t(w)).sum() for k, w in wts.items())
    tg = torch.autograd.grad(loss, list(leaves.values())
                             + ([tpose] if pose_mode else []))
    _check([jgp[k] for k in PARAMS], tg[:len(PARAMS)], PARAMS, **GRAD_TOL)
    if pose_mode:
        _check([jgpose], tg[-1:], ["pose"], 2e-3, 5e-3)
