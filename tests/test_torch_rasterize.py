"""PyTorch port of the blend, rasterize and the render path vs the JAX
package (CPU). The JAX Pallas blend runs in interpret mode, as the JAX
package's own tests run it; the port's wrappers run their plain versions
on CPU tensors. State crosses packages as numpy (langscenex_tpu_torch.
convert) and as PLY files."""
import functools
import math

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
from langscenex_tpu.ops.rasterize import rasterize as jax_rasterize
from langscenex_tpu.ops.rasterize_pallas import blend_tiles_pallas
from langscenex_tpu.scene import ply_io as jply
from langscenex_tpu.scene.cameras import Camera as JCamera
from langscenex_tpu.scene.gaussians import GaussianState as JState
from langscenex_tpu.train.field import render_view as jax_render_view
from langscenex_tpu.train.render_mode import \
    render_all_views as jax_render_all_views
from langscenex_tpu_torch import _build, convert
from langscenex_tpu_torch.ops.binning import TileLists
from langscenex_tpu_torch.ops.rasterize import RasterConfig, rasterize
from langscenex_tpu_torch.ops.rasterize_cuda import blend_tiles
from langscenex_tpu_torch.scene import ply_io as tply
from langscenex_tpu_torch.scene.cameras import Camera
from langscenex_tpu_torch.train.field import render_view
from langscenex_tpu_torch.train.render_mode import render_all_views

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

W, H = 128, 64                       # 4x2 grid of 32x32 tiles
FOVX = 1.0
FOVY = jtf.focal2fov(jtf.fov2focal(FOVX, W), H)
PROJ = jtf.projection_matrix(0.01, 100.0, FOVX, FOVY)
# exact-style config at test size: K1 + a mid tier + catch-all, rank key,
# compaction and the sort engine (interpret mode on the JAX side)
EXACT = dict(tile_w=32, tile_h=32, max_tiles_per_splat=4, chunk=128,
             max_splats_per_tile=1024, big_splats=16,
             extra_tiers=((128, 4),), rank_key_sort=True, max_pairs=4000,
             compact_sort=True, pallas_sort=True)
# Pallas/kernel vs the plain masked-cumsum blend (test_rasterize_pallas.py
# :88-106): the log-space carry and the cumsum round differently, and
# the Pallas blend takes dx, dy from the tile centre where the plain one
# uses global pixel coordinates, so a sample at the alpha >= 1/255 gate or
# the T < 1e-4 sticky stop can flip at a pixel: T moves by up to
# alpha * T there, hence T_ATOL is the dense-occlusion bound (1e-4).
ACC_TOL = dict(atol=2e-4, rtol=1e-3)
DENSE_TOL = dict(atol=5e-4, rtol=1e-3)
T_ATOL = 1e-4


def _t(a):
    return torch.from_numpy(np.array(a))


def _scene(P, seed, dense=False):
    rng = np.random.default_rng(seed)
    means = np.stack([rng.uniform(-1.2, 1.2, P), rng.uniform(-0.6, 0.6, P),
                      rng.uniform(2, 6, P)], -1).astype(np.float32)
    scales = np.exp(rng.uniform(-3.5, -1.8, (P, 3))).astype(np.float32)
    quats = rng.normal(size=(P, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    opac = (np.full(P, 0.97) if dense else rng.uniform(0.2, 0.95, P)
            ).astype(np.float32)
    shs = (0.4 * rng.normal(size=(P, 16, 3))).astype(np.float32)
    feats = rng.uniform(-1, 1, (P, 11)).astype(np.float32)
    return means, scales, quats, opac, shs, feats


def _jcam(w2c=np.eye(4, dtype=np.float32)):
    return JCam(w2c=jnp.asarray(w2c), proj=jnp.asarray(PROJ), width=W,
                height=H, tan_fovx=math.tan(FOVX / 2),
                tan_fovy=math.tan(FOVY / 2))


def _tcam(w2c=np.eye(4, dtype=np.float32), device="cpu"):
    return convert.raster_camera_from_numpy(
        w2c, PROJ, W, H, math.tan(FOVX / 2), math.tan(FOVY / 2), device)


@functools.partial(jax.jit, static_argnums=(5, 6, 7))
def _jax_blend(lists, mean2d, conic, op, ch, gx, gy, cfg):
    return blend_tiles_pallas(lists, mean2d, conic, op, ch, gx, gy, cfg)


@jax.jit
def _jax_lists(means, scales, quats, opac, colors):
    proc = jax_preprocess(means, scales, quats, _jcam(), tile_w=32,
                          tile_h=32, opacity=opac, colors_precomp=colors)
    lists = jax_build(proc, 4, 2, 8, max_pairs=4000, big_splats=256,
                      rank_key=True)
    return proc, lists, jnp.where(proc.visible, opac, 0.0)


@pytest.mark.parametrize("dense", [False, True])
def test_plain_blend_matches_pallas_blend(dense):
    # same lists and payload on both sides (JAX preprocess + binning)
    means, scales, quats, opac, shs, feats = _scene(600, 1, dense)
    colors = np.concatenate([np.abs(shs[:, 0]), feats], 1)      # 14 ch
    proc, lists, op = _jax_lists(*map(jnp.asarray, (means, scales, quats,
                                                    opac, colors)))
    cfg = JConfig(tile_w=32, tile_h=32, max_pairs=4000)
    with pltpu.force_tpu_interpret_mode():
        ja, jt, jo = _jax_blend(lists, proc.mean2d, proc.conic, op,
                                jnp.asarray(colors), 4, 2, cfg)
    tl = TileLists(*(_t(x) for x in lists[:7]))
    ta, tt, to = blend_tiles(tl, _t(proc.mean2d), _t(proc.conic), _t(op),
                             _t(colors), 4, 2, RasterConfig(max_pairs=4000))
    assert int(np.asarray(lists.tile_counts).max()) > 128   # several chunks
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja),
                               **(DENSE_TOL if dense else ACC_TOL))
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=T_ATOL)
    od = np.abs(to.numpy() - np.asarray(jo))
    if dense:
        assert od.max() <= 2 and np.mean(od > 0) < 0.02
    else:
        np.testing.assert_array_equal(to.numpy(), np.asarray(jo))


def _jax_rasterize_exact(means, scales, quats, opac, shs, lang, inst, amap):
    cfg = JConfig(use_pallas=True, **EXACT)
    f = jax.jit(lambda *a: jax_rasterize(
        *a[:4], _jcam(), jnp.asarray([0.1, 0.2, 0.3]), shs=a[4], sh_degree=3,
        language_feature=a[5], instance_feature=a[6], all_map=a[7], cfg=cfg))
    with pltpu.force_tpu_interpret_mode():
        return f(*map(jnp.asarray, (means, scales, quats, opac, shs, lang,
                                    inst, amap)))


def _plane_ok(all_map):
    """Pixels where plane depth is well conditioned: covered (alpha > 0.5)
    and |n . ray| > 0.1 — plane depth divides by n . ray, so a pixel
    where it nears 0 magnifies any blend rounding without bound."""
    am = np.asarray(all_map)
    fx, fy = W / (2 * math.tan(FOVX / 2)), H / (2 * math.tan(FOVY / 2))
    xs = (np.arange(W) - 0.5 * W) / fx
    ys = (np.arange(H) - 0.5 * H) / fy
    denom = am[0] * xs[None, :] + am[1] * ys[:, None] + am[2]
    return (am[3] > 0.5) & (np.abs(denom) > 0.1)


def _compare_outputs(a, b, tol=ACC_TOL):
    for f in ("color", "language", "instance", "all_map"):
        np.testing.assert_allclose(getattr(b, f).numpy(),
                                   np.asarray(getattr(a, f)), err_msg=f,
                                   **tol)
    np.testing.assert_allclose(b.final_T.numpy(), np.asarray(a.final_T),
                               atol=T_ATOL)
    ok = _plane_ok(a.all_map)
    assert ok.mean() > 0.3
    np.testing.assert_allclose(b.plane_depth.numpy()[ok],
                               np.asarray(a.plane_depth)[ok], rtol=2e-3,
                               atol=1e-3)
    for f in ("radii", "visible", "pairs_overflowed", "k_overflowed",
              "num_pairs", "num_big"):
        np.testing.assert_array_equal(getattr(b, f).numpy(),
                                      np.asarray(getattr(a, f)), err_msg=f)
    od = np.abs(b.out_observe.numpy() - np.asarray(a.out_observe))
    assert od.max() <= 2 and np.mean(od > 0) < 0.02


def test_rasterize_exact_config_matches_jax():
    means, scales, quats, opac, shs, feats = _scene(600, 2)
    lang, inst = feats[:, :3], feats[:, 3:6]
    amap = np.concatenate([feats[:, 6:9], np.ones((600, 1)), feats[:, 9:10]
                           + 3.0], 1).astype(np.float32)
    a = _jax_rasterize_exact(means, scales, quats, opac, shs, lang, inst,
                             amap)
    _build.reset_launch_counts()
    b = rasterize(*map(_t, (means, scales, quats, opac)), _tcam(),
                  torch.tensor([0.1, 0.2, 0.3]), shs=_t(shs), sh_degree=3,
                  language_feature=_t(lang), instance_feature=_t(inst),
                  all_map=_t(amap), cfg=RasterConfig(use_pallas=True,
                                                     **EXACT))
    assert not bool(a.pairs_overflowed) and int(a.num_pairs) > 1000
    _compare_outputs(a, b)
    assert sum(_build.launch_counts.values()) == 0     # CPU: plain versions
    # the plain path selected explicitly gives the same render
    c = rasterize(*map(_t, (means, scales, quats, opac)), _tcam(),
                  torch.tensor([0.1, 0.2, 0.3]), shs=_t(shs), sh_degree=3,
                  language_feature=_t(lang), instance_feature=_t(inst),
                  all_map=_t(amap), cfg=RasterConfig(use_pallas=False,
                                                     **EXACT))
    torch.testing.assert_close(c.color, b.color, atol=0, rtol=0)


def _state_numpy(P, seed):
    means, scales, quats, opac, shs, feats = _scene(P, seed)
    alive = np.ones(P, bool)
    alive[-P // 10:] = False                         # capacity padding
    return dict(xyz=means, knn_f=np.zeros((P, 6), np.float32),
                features_dc=shs[:, :1].copy(), features_rest=shs[:, 1:].copy(),
                scaling=np.log(scales), rotation=quats * 1.7,
                opacity=np.log(opac / (1 - opac))[:, None],
                language_feature=feats[:, :3].copy(),
                instance_feature=feats[:, 3:6].copy(), alive=alive)


def _cams(n):
    out = []
    for i in range(n):
        a = math.radians(2.0 * i)
        R = np.array([[math.cos(a), 0, math.sin(a)], [0, 1, 0],
                      [-math.sin(a), 0, math.cos(a)]])
        T = np.array([0.05 * i, -0.02 * i, 0.1 * i])
        out.append((R, T))
    return ([JCamera(uid=i, colmap_id=i, R=R, T=T, fovx=FOVX, fovy=FOVY,
                     width=W, height=H) for i, (R, T) in enumerate(out)],
            [Camera(uid=i, colmap_id=i, R=R, T=T, fovx=FOVX, fovy=FOVY,
                    width=W, height=H) for i, (R, T) in enumerate(out)])


# the JAX XLA blend path, untruncated at this size (max tile list < 1024)
RENDER_J = JConfig(tile_w=32, tile_h=32, max_pairs=8000, use_pallas=False,
                   max_splats_per_tile=1024)
RENDER_T = RasterConfig(tile_w=32, tile_h=32, max_pairs=8000)


@pytest.mark.parametrize("pose_mode", [False, True])
def test_render_view_matches_jax(pose_mode):
    d = _state_numpy(500, 3)
    jstate = JState(**{k: jnp.asarray(v) for k, v in d.items()})
    tstate = convert.gaussian_state_from_numpy(d)
    jcams, tcams = _cams(2)
    w2c = jcams[1].w2c
    pose = np.array([0.999, 0.02, -0.03, 0.01, 0.1, -0.05, 0.2], np.float32)
    jf = jax.jit(lambda s, p, w: jax_render_view(
        s, p, w, jcams[0].raster_camera(), jnp.zeros(3), 3, True, True,
        None, RENDER_J))
    a = jf(jstate, jnp.asarray(pose) if pose_mode else None, jnp.asarray(w2c))
    b = render_view(tstate, _t(pose) if pose_mode else None, _t(w2c),
                    tcams[0].raster_camera(), torch.zeros(3), 3, True, True,
                    None, RENDER_T)
    assert int(np.asarray(a.num_pairs)) > 500
    _compare_outputs(a, b)


def test_render_all_views_matches_jax():
    d = _state_numpy(500, 4)
    jstate = JState(**{k: jnp.asarray(v) for k, v in d.items()})
    tstate = convert.gaussian_state_from_numpy(d)
    jcams, tcams = _cams(3)
    ja = list(jax_render_all_views(jstate, jcams, RENDER_J))
    tb = list(render_all_views(tstate, tcams, RENDER_T))
    assert len(ja) == len(tb) == 3
    for (jc, jm), (tc, tm) in zip(ja, tb):
        assert jc.uid == tc.uid
        for k in ("render", "rendered_normal", "alpha", "language_feature",
                  "instance_feature"):
            np.testing.assert_allclose(tm[k].numpy(), jm[k], err_msg=k,
                                       **ACC_TOL)
        ok = _plane_ok(np.concatenate([jm["rendered_normal"],
                                       jm["alpha"][None]], 0))
        np.testing.assert_allclose(tm["plane_depth"].numpy()[ok],
                                   jm["plane_depth"][ok], rtol=2e-3,
                                   atol=1e-3)
        assert not bool(tm["pairs_overflowed"])


def test_ply_round_trip_across_packages(tmp_path):
    d = _state_numpy(120, 5)
    jstate = JState(**{k: jnp.asarray(v) for k, v in d.items()})
    jply.save_ply(jstate, str(tmp_path / "jax.ply"))
    t_loaded = tply.load_ply(str(tmp_path / "jax.ply"), capacity=120)
    tply.save_ply(convert.gaussian_state_from_numpy(d),
                  str(tmp_path / "torch.ply"))
    j_loaded = jply.load_ply(str(tmp_path / "torch.ply"), capacity=120)
    assert (tmp_path / "jax.ply").read_bytes() == \
        (tmp_path / "torch.ply").read_bytes()
    n = int(d["alive"].sum())
    for f in ("xyz", "features_dc", "features_rest", "scaling", "rotation",
              "opacity", "language_feature", "instance_feature", "alive"):
        np.testing.assert_array_equal(getattr(t_loaded, f).numpy(),
                                      np.asarray(getattr(j_loaded, f)),
                                      err_msg=f)
        np.testing.assert_array_equal(getattr(t_loaded, f).numpy()[:n],
                                      d[f][d["alive"]], err_msg=f)


@pytest.mark.parametrize("knob", [dict(depth_presort=True),
                                  dict(payload_depth_rank=True),
                                  dict(packed_sort=True),
                                  dict(key_only_sort=True),
                                  dict(align_free=False)])
def test_unported_config_knobs_raise(knob):
    with pytest.raises(NotImplementedError):
        RasterConfig(**knob)
