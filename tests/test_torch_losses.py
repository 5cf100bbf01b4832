"""Losses, multi-view consistency, depth normals, border sampling and the
kNN scale initialiser of the PyTorch port vs the JAX package (CPU,
float32): values and gradients on the same numpy inputs. Where the JAX
function draws with a PRNG key, the test draws the same indices with
``jax.random`` and hands them to the port."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_threads import few_torch_threads  # noqa: F401

from langscenex_tpu.ops import depth_normal as jdn
from langscenex_tpu.ops import interp as jinterp
from langscenex_tpu.ops import knn as jknn
from langscenex_tpu.ops import losses as jl
from langscenex_tpu.train import multiview as jmv
from langscenex_tpu_torch.ops import depth_normal as tdn
from langscenex_tpu_torch.ops import interp as tinterp
from langscenex_tpu_torch.ops import knn as tknn
from langscenex_tpu_torch.ops import losses as tl
from langscenex_tpu_torch.train import multiview as tmv


def _t(a):
    return torch.from_numpy(np.array(a))


def _perm(key, n, k):
    return np.asarray(jax.random.permutation(key, n)[:min(k, n)])


def _compare(jf, tf, ins, argnums, rtol=1e-5, atol=1e-6, grad_tol=1e-4):
    """Value and gradients (w.r.t. ``argnums``) of a scalar loss."""
    jv, jg = jax.jit(jax.value_and_grad(jf, argnums=argnums))(
        *map(jnp.asarray, ins))
    leaves = [_t(x).requires_grad_() if i in argnums else _t(x)
              for i, x in enumerate(ins)]
    tv = tf(*leaves)
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=rtol,
                               atol=atol)
    tg = torch.autograd.grad(tv, [leaves[i] for i in argnums])
    for a, b in zip(jg, tg):
        a = np.asarray(a)
        scale = max(np.abs(a).max(), 1e-8)
        np.testing.assert_allclose(b.numpy(), a, atol=grad_tol * scale,
                                   rtol=grad_tol)


def _images(seed, C=3, H=40, W=56):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (C, H, W)).astype(np.float32)
    y = np.clip(x + 0.1 * rng.normal(size=x.shape), 0, 1).astype(np.float32)
    return x, y


def test_image_losses_match_jax():
    x, y = _images(0)
    # f32 sums in another order (shifted slices vs XLA's convolution)
    _compare(jl.ssim, tl.ssim, (x, y), (0,), rtol=1e-5, grad_tol=1e-4)
    _compare(jl.l1_loss, tl.l1_loss, (x, y), (0,))
    np.testing.assert_allclose(tl.image_grad_weight(_t(y)).numpy(),
                               np.asarray(jl.image_grad_weight(jnp.asarray(y))),
                               atol=1e-6)


def test_ssim_is_exact_f32_under_tf32_flags():
    x, y = _images(1)
    prev = torch.get_float32_matmul_precision(), torch.backends.cudnn.allow_tf32
    try:
        torch.set_float32_matmul_precision("medium")
        torch.backends.cudnn.allow_tf32 = True
        v = float(tl.ssim(_t(x), _t(y)))
        with tl.exact_f32():
            assert torch.get_float32_matmul_precision() == "highest"
            assert not torch.backends.cudnn.allow_tf32
        assert torch.get_float32_matmul_precision() == "medium"
    finally:
        torch.set_float32_matmul_precision(prev[0])
        torch.backends.cudnn.allow_tf32 = prev[1]
    np.testing.assert_allclose(v, float(jl.ssim(jnp.asarray(x),
                                                jnp.asarray(y))), rtol=1e-5)


def test_lncc_and_ranking_match_jax():
    rng = np.random.default_rng(2)
    ref = rng.uniform(0, 1, (64, 49)).astype(np.float32)
    nea = (0.7 * ref + 0.3 * rng.uniform(0, 1, (64, 49))).astype(np.float32)
    jv, jm = jl.lncc(jnp.asarray(ref), jnp.asarray(nea))
    tv, tm = tl.lncc(_t(ref), _t(nea))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-5)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    err = rng.uniform(0, 1, (17, 9)).astype(np.float32)
    for ratio, kind in ((1.0, "mean"), (0.3, "sum"), (0.0, "mean")):
        _compare(lambda e: jl.ranking_loss(e, ratio, kind),
                 lambda e: tl.ranking_loss(e, ratio, kind), (err,), (0,))


def test_loss_cls_3d_matches_jax():
    rng = np.random.default_rng(3)
    N = 3000
    xyz = rng.uniform(-1, 1, (N, 3)).astype(np.float32)
    xyz[-600:] = 0.0               # dead slots: ties at distance 0
    xyz[100:110] = xyz[200]        # duplicated points: more ties
    preds = rng.uniform(-1, 1, (N, 3)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    idx = _perm(key, N, 800)
    assert (idx >= N - 600).sum() > 50
    _compare(lambda f, p: jl.loss_cls_3d(key, f, p, 5, 4.0),
             lambda f, p: tl.loss_cls_3d(_t(idx), f, p, 5, 4.0),
             (xyz, preds), (1,), rtol=1e-5, grad_tol=1e-4)


def test_grouping_losses_match_jax():
    rng = np.random.default_rng(4)
    n = 2000
    seg = rng.integers(-1, 6, n).astype(np.int32)
    feat = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    inst = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    k1, k2 = jax.random.PRNGKey(3), jax.random.PRNGKey(5)
    i1, i2 = _perm(k1, n, 600), _perm(k2, n, 300)
    _compare(lambda s, f: jl.loss_semantic_group(k1, s, f, num=600),
             lambda s, f: tl.loss_semantic_group(_t(i1), s, f),
             (seg, feat), (1,), rtol=1e-5, grad_tol=1e-4)
    _compare(lambda s, a, b: jl.loss_instance_group(k2, s, a, b, num=300),
             lambda s, a, b: tl.loss_instance_group(_t(i2), s, a, b),
             (seg, inst, feat), (1, 2), rtol=1e-5, grad_tol=1e-4)


def test_depth_normals_and_sampling_match_jax():
    rng = np.random.default_rng(5)
    H, W = 24, 40
    depth = (3.0 + rng.uniform(0, 0.5, (H, W))).astype(np.float32)
    K = np.array([[50.0, 0, W / 2], [0, 48.0, H / 2], [0, 0, 1]], np.float32)
    pts = np.asarray(jdn.depth_to_points_cam(jnp.asarray(depth),
                                             jnp.asarray(K)))
    np.testing.assert_allclose(
        tdn.depth_to_points_cam(_t(depth), _t(K)).numpy(), pts, rtol=1e-5,
        atol=1e-5)
    wts = rng.normal(size=(H, W, 3)).astype(np.float32)
    _compare(lambda p: jnp.sum(jdn.points_to_normals(p) * wts),
             lambda p: (tdn.points_to_normals(p) * _t(wts)).sum(), (pts,),
             (0,), rtol=1e-5, grad_tol=1e-4)
    img = rng.uniform(0, 1, (2, H, W)).astype(np.float32)
    xy = np.stack([rng.uniform(-3, W + 3, 500), rng.uniform(-3, H + 3, 500)],
                  -1).astype(np.float32)
    w2 = rng.normal(size=(2, 500)).astype(np.float32)
    _compare(lambda a, b: jnp.sum(jinterp.bilinear_sample_border(a, b) * w2),
             lambda a, b: (tinterp.bilinear_sample_border(a, b)
                           * _t(w2)).sum(), (img, xy), (0, 1))


def test_mean_dist3_sq_matches_jax():
    rng = np.random.default_rng(6)
    pts = rng.uniform(-2, 2, (3000, 3)).astype(np.float32)
    pts[:20] = pts[20]                          # coincident points
    a = np.asarray(jax.jit(jknn.mean_dist3_sq)(jnp.asarray(pts)))
    b = tknn.mean_dist3_sq(_t(pts)).numpy()
    # the same morton windows and candidate merge; f32 distance sums may
    # round differently, which at most reorders near-equal candidates
    np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-9)


def _mv_inputs(seed, H=32, W=48):
    """A tilted plane seen by two nearby cameras."""
    rng = np.random.default_rng(seed)
    fx = fy = 40.0
    K = np.array([[fx, 0, W / 2], [0, fy, H / 2], [0, 0, 1]], np.float32)
    gx, gy = np.meshgrid(np.arange(W), np.arange(H))
    depth = (3.0 + 0.01 * gx + 0.005 * gy
             + 0.02 * rng.normal(size=(H, W))).astype(np.float32)
    n = np.array([0.1, 0.05, -1.0])
    n /= np.linalg.norm(n)
    normal = np.broadcast_to(n[:, None, None], (3, H, W)).astype(np.float32)
    normal = (normal + 0.01 * rng.normal(size=(3, H, W))).astype(np.float32)
    dist = (3.0 + 0.05 * rng.normal(size=(H, W))).astype(np.float32)
    near_depth = (depth + 0.02 * rng.normal(size=(H, W))).astype(np.float32)
    gray = rng.uniform(0, 1, (1, H, W)).astype(np.float32)
    near_gray = np.clip(gray + 0.05 * rng.normal(size=gray.shape), 0, 1
                        ).astype(np.float32)
    a = np.radians(1.5)
    v = np.eye(4, dtype=np.float32)
    nw = np.eye(4, dtype=np.float32)
    nw[:3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                  [-np.sin(a), 0, np.cos(a)]]
    nw[:3, 3] = (0.05, 0.0, 0.02)
    return depth, normal, dist, near_depth, gray, near_gray, v, nw, K


@pytest.mark.parametrize("dense", [True, False])
def test_multi_view_loss_matches_jax(dense):
    ins = _mv_inputs(8)
    H, W = ins[0].shape
    key = jax.random.PRNGKey(11)
    sel = _perm(key, H * W, 700)

    def jf(d, nrm, dist, nd):
        o = jmv.multi_view_loss(key, d, nrm, dist, nd, *map(jnp.asarray,
                                                           ins[4:]),
                                sample_num=700, ncc_dense=dense)
        return o.geo_loss + o.ncc_loss, o

    def tf(d, nrm, dist, nd):
        o = tmv.multi_view_loss(_t(sel), d, nrm, dist, nd,
                                *map(_t, ins[4:]), ncc_dense=dense)
        return o.geo_loss + o.ncc_loss, o

    (jv, jo), jg = jax.jit(jax.value_and_grad(jf, argnums=(0, 1, 2, 3),
                                              has_aux=True))(
        *map(jnp.asarray, ins[:4]))
    leaves = [_t(x).requires_grad_() for x in ins[:4]]
    tv, to = tf(*leaves)
    assert int(to.n_valid) == int(jo.n_valid) > H * W // 2
    # point reprojection: explicit f32 sums vs XLA's HIGHEST matmuls
    np.testing.assert_allclose(float(to.geo_loss), float(jo.geo_loss),
                               rtol=1e-4)
    np.testing.assert_allclose(float(to.ncc_loss), float(jo.ncc_loss),
                               rtol=1e-4)
    assert float(to.ncc_loss) > 0
    tg = torch.autograd.grad(tv, leaves)
    # per-pixel gradients sum cancelling reprojection and NCC terms, so a
    # small element carries the rounding of the large ones: 1e-2 of each
    # array's largest magnitude + 1e-3 relative
    for a, b in zip(jg, tg):
        a = np.asarray(a)
        scale = max(np.abs(a).max(), 1e-8)
        np.testing.assert_allclose(b.numpy(), a, atol=1e-2 * scale,
                                   rtol=1e-3)
