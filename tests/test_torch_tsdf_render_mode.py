"""TSDF fusion, meshes and the render and eval modes of the PyTorch port
against the JAX package (CPU): ``integrate`` on the same depth maps, the
vectorised ``extract_mesh`` / ``post_process_mesh`` against the JAX
loops, the mesh PLY bytes, ``pca_colormap`` and the colormaps, and
``render_result`` / ``eval_result`` / ``eval_views`` on the same splats
(the JAX side on its XLA blend). PNGs are read back with PIL here."""
import math
import os

import jax.numpy as jnp
import numpy as np
import torch
from PIL import Image
from test_torch_threads import few_torch_threads  # noqa: F401

from langscenex_tpu.ops import tsdf as jtsdf
from langscenex_tpu.ops import transforms as jtf
from langscenex_tpu.ops.rasterize import RasterConfig as JConfig
from langscenex_tpu.scene.cameras import Camera as JCamera
from langscenex_tpu.scene.cameras import rgb_to_gray
from langscenex_tpu.scene.gaussians import GaussianState as JState
from langscenex_tpu.train import render_mode as jrm
from langscenex_tpu.utils import colormaps as jcm
from langscenex_tpu_torch import convert
from langscenex_tpu_torch.ops import tsdf as ttsdf
from langscenex_tpu_torch.ops.rasterize import RasterConfig
from langscenex_tpu_torch.scene.cameras import Camera
from langscenex_tpu_torch.train import render_mode as trm
from langscenex_tpu_torch.utils import colormaps as tcm

W, H = 64, 48
FOVX = 1.0
FOVY = jtf.focal2fov(jtf.fov2focal(FOVX, W), H)
# the blends differ by their rounding (test_torch_rasterize.ACC_TOL)
ACC_TOL = dict(atol=2e-4, rtol=1e-3)
RENDER_J = JConfig(tile_w=32, tile_h=32, max_pairs=8000, use_pallas=False,
                   max_splats_per_tile=1024)
RENDER_T = RasterConfig(tile_w=32, tile_h=32, max_pairs=8000)


# ---- TSDF -------------------------------------------------------------------

def _fused(channels=3):
    """The same three views integrated into a JAX and a port volume."""
    rng = np.random.default_rng(0)
    dims, origin, vs = (40, 36, 30), np.array([-1, -1, 0.5], np.float32), 0.05
    K = np.array([[60, 0, 32], [0, 60, 24], [0, 0, 1]], np.float32)
    jv = jtsdf.create_volume(origin, vs, dims, channels)
    tv = ttsdf.create_volume(origin, vs, dims, channels, device="cpu")
    for i in range(3):
        d = (1.5 + 0.3 * np.sin(np.arange(W) / 7)[None]
             + 0.2 * rng.random((H, W))).astype(np.float32)
        d[:5, :9] = 0.0                                     # holes
        w2c = np.eye(4, dtype=np.float32)
        w2c[0, 3] = 0.05 * i
        col = rng.random((channels, H, W)).astype(np.float32)
        jv = jtsdf.integrate(jv, jnp.asarray(d), jnp.asarray(K),
                             jnp.asarray(w2c), jnp.asarray(col), trunc=4 * vs)
        tv = ttsdf.integrate(tv, torch.from_numpy(d), K, w2c,
                             torch.from_numpy(col), trunc=4 * vs)
    return jv, tv


def test_integrate_matches_jax():
    jv, tv = _fused()
    for f in ("tsdf", "weight", "color"):
        np.testing.assert_allclose(getattr(tv, f).numpy(),
                                   np.asarray(getattr(jv, f)), atol=1e-5,
                                   rtol=0, err_msg=f)
    assert float(tv.weight.max()) == 3.0


def _canonical_faces(verts, faces):
    """Faces as rows of vertex positions (each rotated to start at its
    smallest vertex, orientation kept), sorted: independent of vertex
    order."""
    key = np.round(verts.astype(np.float64), 5)
    tri = key[faces]                                       # [F,3,3]
    lex = np.lexsort(tri.transpose(2, 0, 1)[::-1].reshape(3, -1))
    rank = np.empty(len(lex), np.int64)
    rank[lex] = np.arange(len(lex))
    rank = rank.reshape(-1, 3)
    start = rank.argmin(1)
    rot = np.stack([np.roll(t, -s, 0) for t, s in zip(tri, start)])
    flat = rot.reshape(len(rot), -1)
    return flat[np.lexsort(flat.T[::-1])]


def test_mesh_extraction_matches_jax_loops(tmp_path):
    # the vectorised marching tetrahedra and triangle clustering give the
    # JAX loops' mesh: vertices within 1e-6 and the same faces (here even
    # in the same order); the PLY bytes are identical
    jv, tv = _fused()
    jm = jtsdf.extract_mesh(jv)
    tm = ttsdf.extract_mesh(tv)
    assert len(jm[1]) > 1000
    np.testing.assert_allclose(tm[0], jm[0], atol=1e-6, rtol=0)
    np.testing.assert_allclose(tm[2], jm[2], atol=1e-6, rtol=0)
    np.testing.assert_array_equal(_canonical_faces(*tm[:2]),
                                  _canonical_faces(*jm[:2]))
    np.testing.assert_array_equal(tm[1], jm[1])
    # floaters: small disconnected clusters are dropped, degenerate
    # triangles and unused vertices removed
    rng = np.random.default_rng(1)
    fv = rng.uniform(-1, 1, (30, 3)).astype(np.float32)
    ff = rng.integers(0, 30, (20, 3)) + len(jm[0])
    ff[0] = [ff[0, 0], ff[0, 0], ff[0, 1]]
    verts = np.concatenate([jm[0], fv])
    faces = np.concatenate([jm[1], ff.astype(np.int32)])
    cols = np.concatenate([jm[2], rng.random((30, 3)).astype(np.float32)])
    jp = jtsdf.post_process_mesh(verts, faces, cols)
    tp = ttsdf.post_process_mesh(verts, faces, cols)
    for a, b in zip(tp, jp):
        np.testing.assert_array_equal(a, b)
    assert len(tp[1]) < len(faces)
    jtsdf.save_mesh_ply(str(tmp_path / "j.ply"), *jp)
    ttsdf.save_mesh_ply(str(tmp_path / "t.ply"), *tp)
    assert (tmp_path / "t.ply").read_bytes() == (tmp_path / "j.ply"
                                                 ).read_bytes()
    ttsdf.save_mesh_ply(str(tmp_path / "n.ply"), tp[0], tp[1])
    jtsdf.save_mesh_ply(str(tmp_path / "m.ply"), jp[0], jp[1])
    assert (tmp_path / "n.ply").read_bytes() == (tmp_path / "m.ply"
                                                 ).read_bytes()


def test_empty_volume_gives_empty_mesh():
    vol = ttsdf.create_volume(np.zeros(3), 0.1, (8, 8, 8), device="cpu")
    v, f, c = ttsdf.extract_mesh(vol)
    assert v.shape == (0, 3) and f.shape == (0, 3) and c.shape == (0, 3)
    assert ttsdf.post_process_mesh(v, f, c)[1].shape == (0, 3)


# ---- colormaps --------------------------------------------------------------

def test_pca_and_colormaps_match_jax():
    rng = np.random.default_rng(2)
    feat = rng.normal(size=(3, 12, 16)).astype(np.float32)
    np.testing.assert_array_equal(trm.pca_colormap(feat),
                                  jrm.pca_colormap(feat))
    x = rng.normal(size=(12, 16)).astype(np.float32)
    np.testing.assert_array_equal(tcm.turbo(tcm.normalize(x)),
                                  jcm.turbo(jcm.normalize(x)))
    np.testing.assert_array_equal(tcm.apply_colormap(x),
                                  jcm.apply_colormap(x))
    np.testing.assert_array_equal(tcm.apply_colormap(feat),
                                  jcm.apply_colormap(feat))


# ---- render and eval modes ----------------------------------------------------

def _splats(P=400, seed=3):
    rng = np.random.default_rng(seed)
    means = np.stack([rng.uniform(-1.0, 1.0, P), rng.uniform(-0.6, 0.6, P),
                      rng.uniform(2, 4, P)], -1).astype(np.float32)
    opac = rng.uniform(0.3, 0.95, P).astype(np.float32)
    shs = (0.4 * rng.normal(size=(P, 16, 3))).astype(np.float32)
    alive = np.ones(P, bool)
    alive[-P // 10:] = False
    d = dict(xyz=means, knn_f=np.zeros((P, 6), np.float32),
             features_dc=shs[:, :1].copy(), features_rest=shs[:, 1:].copy(),
             scaling=np.log(np.exp(rng.uniform(-3.2, -1.8, (P, 3)))
                            ).astype(np.float32),
             rotation=rng.normal(size=(P, 4)).astype(np.float32),
             opacity=np.log(opac / (1 - opac))[:, None],
             language_feature=rng.uniform(-1, 1, (P, 3)).astype(np.float32),
             instance_feature=rng.uniform(-1, 1, (P, 3)).astype(np.float32),
             alive=alive)
    return (JState(**{k: jnp.asarray(v) for k, v in d.items()}),
            convert.gaussian_state_from_numpy(d, "cpu"))


def _cams(n=3):
    rng = np.random.default_rng(4)
    jc, tc = [], []
    for i in range(n):
        a = math.radians(2.0 * i)
        R = np.array([[math.cos(a), 0, math.sin(a)], [0, 1, 0],
                      [-math.sin(a), 0, math.cos(a)]])
        T = np.array([0.05 * i, -0.02 * i, 0.1 * i])
        img = rng.uniform(0, 1, (3, H, W)).astype(np.float32)
        kw = dict(uid=i, colmap_id=i + 1, R=R, T=T, fovx=FOVX, fovy=FOVY,
                  width=W, height=H, image_name=f"{i + 1:04d}", image=img,
                  image_gray=rgb_to_gray(img))
        jc.append(JCamera(**kw))
        tc.append(Camera(**kw))
    return jc, tc


def _tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def _png(path):
    with Image.open(path) as im:
        return np.asarray(im).astype(int)


def _ply_counts(path):
    with open(path, "rb") as f:
        head = f.read(400).split(b"end_header")[0].decode()
    return [int(l.split()[-1]) for l in head.splitlines()
            if l.startswith("element")]


def test_render_result_matches_jax(tmp_path):
    # JAX's artifact tree, file name for file name; the .npy maps within
    # the render tolerance, PNG pixels within 1 LSB, mesh vertex and face
    # counts within 2% (a voxel's sign can flip with the depth's rounding)
    js, ts = _splats()
    jc, tc = _cams()
    jrm.render_result(js, jc, str(tmp_path / "j"), RENDER_J, sh_degree=3,
                      voxel_size=0.05)
    stats = trm.render_result(ts, tc, str(tmp_path / "t"), RENDER_T,
                              sh_degree=3, voxel_size=0.05)
    tree = _tree(tmp_path / "j")
    assert tree == _tree(tmp_path / "t")
    assert {"mesh.ply", "mesh_post.ply", "feature_mesh.ply",
            "feature_mesh_post.ply", "0001_render.png",
            "0003_language_pca.png"} <= set(tree)
    for f in tree:
        a, b = tmp_path / "t" / f, tmp_path / "j" / f
        if f.endswith(".npy"):
            np.testing.assert_allclose(np.load(a), np.load(b), err_msg=f,
                                       **ACC_TOL)
        elif f.endswith(".png"):
            assert np.abs(_png(a) - _png(b)).max() <= 1, f
        else:
            ca, cb = _ply_counts(a), _ply_counts(b)
            assert cb[0] > 100, f
            for x, y in zip(ca, cb):
                assert abs(x - y) <= 0.02 * y, (f, ca, cb)
    assert stats["mesh.ply"]["vertices"] == _ply_counts(
        tmp_path / "t" / "mesh.ply")[0]
    assert set(stats["mesh.ply"]) >= {"fuse_s", "extract_s", "post_s"}


def test_eval_views_and_result_match_jax(tmp_path):
    # after 2 pose iterations the pose within 1e-4, the PSNR within
    # 0.05 dB, and eval_result's artifact tree with its maps as above
    js, ts = _splats()
    jc, tc = _cams()
    jres = jrm.eval_result(js, jc, str(tmp_path / "j"), RENDER_J,
                           sh_degree=3, pose_optim_iters=2)
    tres = trm.eval_result(ts, tc, str(tmp_path / "t"), RENDER_T,
                           sh_degree=3, pose_optim_iters=2)
    assert [r["camera"] for r in tres] == [r["camera"] for r in jres]
    for a, b in zip(tres, jres):
        np.testing.assert_allclose(a["pose"], b["pose"], atol=1e-4, rtol=0)
        assert abs(a["psnr"] - b["psnr"]) <= 0.05
    tree = _tree(tmp_path / "j")
    assert tree == _tree(tmp_path / "t") and len(tree) == 8 * 3
    for f in tree:
        a, b = tmp_path / "t" / f, tmp_path / "j" / f
        if f.endswith(".npy"):
            x, y = np.load(a), np.load(b)
            if "depth" in f:        # plane depth only where well covered
                ok = np.load(tmp_path / "j" / "eval" /
                             "renders_lang_npy" / os.path.basename(f))
                ok = np.abs(ok).sum(-1) > 0.5
                x, y = x[ok], y[ok]
            np.testing.assert_allclose(x, y, err_msg=f, atol=2e-3, rtol=2e-3)
        else:
            assert np.abs(_png(a) - _png(b)).max() <= 1, f


def test_eval_views_fits_the_pose_through_the_shim():
    # one camera seen from a perturbed pose: the fit moves the pose and
    # the loss gradient reaches it through render_view's pose shim
    _, ts = _splats()
    _, tc = _cams(1)
    out = list(trm.eval_views(ts, tc, RENDER_T, 3, pose_optim_iters=0))
    fit = list(trm.eval_views(ts, tc, RENDER_T, 3, pose_optim_iters=3))
    assert not np.allclose(out[0][1], fit[0][1])
    assert set(fit[0][2]) == {"render", "language_feature",
                              "instance_feature", "plane_depth",
                              "rendered_normal"}
    assert np.isfinite(fit[0][3])
