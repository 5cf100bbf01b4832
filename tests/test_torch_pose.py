"""Pose lifting in the PyTorch port vs the JAX package on the CPU: the
``utils/sfm`` helpers one by one, ``estimate_poses_vggt``'s camera npz
files and PLY, ``estimate_poses_dense_init``'s COLMAP tree (images.bin,
cameras.bin, the PLY, the confidence npys, pts_num.txt), the normal
keyframes of ``generate_normals`` and its CLI, and
``FieldConstructionPipeline.preprocess`` with pose estimation on, each on
a tiny scene written to ``tmp_path`` and a tiny VGGT (tests/
test_vggt.py's config) whose seeded weights the JAX model takes through
``convert_vggt``. The JAX VGGT runs jitted (its eager flax apply is slow).

Tolerances: the helpers exact (masks, indices, files, the Lanczos
resize), float results 1e-12 relative in float64 and quaternions 1e-6 in
float32; the redundancy masks EXACT, both on the JAX export's own inputs
and end to end from each package's model; the model-derived values
(poses, intrinsics, points, confidences, focals) 1e-4 absolute + 1e-3
relative (the VGGT bounds of tests/test_torch_vggt.py carried through the
decoding); colours, names, counts and file trees exact; the normal PNGs
exact after the uint8 quantisation but for at most 1% of values: a
random VGGT's depth is rough from pixel to pixel, and where the central
differences' cross product nearly vanishes, float32 rounding turns the
normal (one value moved 12 levels, 0.44% of one frame's values moved)."""
import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_threads import few_torch_threads  # noqa: F401
from test_torch_vggt import J_TINY, pair, port_cfg

import langscenex_tpu.pose_estimation as jpose
from langscenex_tpu import get_normal as jnormal
from langscenex_tpu.models import vggt as jv
from langscenex_tpu.pipeline import FieldConstructionPipeline as JPipeline
from langscenex_tpu.pipeline import PipelinePaths as JPaths
from langscenex_tpu.scene import colmap_io as jcolmap
from langscenex_tpu.utils import sfm as jsfm
from langscenex_tpu.utils.convert import convert_vggt
from langscenex_tpu_torch import get_normal as tnormal
from langscenex_tpu_torch import pose_estimation as tpose
from langscenex_tpu_torch.models import vggt as tv
from langscenex_tpu_torch.pipeline import FieldConstructionPipeline
from langscenex_tpu_torch.pipeline import PipelinePaths
from langscenex_tpu_torch.scene import colmap_io
from langscenex_tpu_torch.scene.dataset_readers import read_ply_points
from langscenex_tpu_torch.utils import png
from langscenex_tpu_torch.utils import sfm

MODEL_TOL = dict(atol=1e-4, rtol=1e-3)
RNG = np.random.default_rng(0)


_FLAX_APPLY = jv.VGGT.apply


@functools.lru_cache(maxsize=None)
def _jitted(cfg):
    return jax.jit(lambda p, *a: _FLAX_APPLY(jv.VGGT(cfg), p, *a))


@pytest.fixture(autouse=True)
def jitted_jax_vggt(monkeypatch):
    """The JAX estimators call ``VGGT(cfg).apply`` eagerly; run it jitted
    (the same program)."""
    monkeypatch.setattr(jv.VGGT, "apply",
                        lambda self, p, *a: _jitted(self.cfg)(p, *a))


@pytest.fixture(scope="module")
def models():
    tm, params = pair(J_TINY, seed=5)
    return tm, params


def write_frames(d, n, h, w, seed=0, start=1):
    os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(seed)
    # smooth images with noise: a gradient per frame plus texture
    ys, xs = np.mgrid[0:h, 0:w]
    for i in range(n):
        base = np.stack([xs * 255 / w, ys * 255 / h,
                         np.full((h, w), 40.0 * i)], -1)
        img = np.clip(base + rng.normal(0, 25, (h, w, 3)), 0, 255)
        png.write_png(os.path.join(d, f"{i + start:04d}.png"),
                      img.astype(np.uint8))


def scene(root, n=3, h=40, w=60):
    write_frames(os.path.join(root, "input"), n, h, w)
    return root


# ------------------------------------------------------------ sfm helpers

def test_sfm_small_helpers_match_jax(tmp_path):
    for w, h in ((640, 480), (1000, 333), (17, 900)):
        assert sfm.resize_to_512(w, h) == jsfm.resize_to_512(w, h)
    pts = RNG.normal(size=(50, 3)) + [0, 0, 4]
    K = np.array([[50.0, 0, 20], [0, 55.0, 15], [0, 0, 1]])
    w2c = np.eye(4)
    w2c[:3, 3] = [0.1, -0.2, 0.3]
    for a, b in zip(sfm.project_points(pts, K, w2c),
                    jsfm.project_points(pts, K, w2c)):
        np.testing.assert_array_equal(a, b)
    depths = [RNG.uniform(1, 3, (12, 16)) for _ in range(3)]
    Ks = [K] * 3
    w2cs = [np.eye(4) for _ in range(3)]
    w2cs[1][:3, 3] = [0.05, 0, 0]
    for a, b in zip(sfm.compute_co_vis_masks(depths, Ks, w2cs),
                    jsfm.compute_co_vis_masks(depths, Ks, w2cs)):
        np.testing.assert_array_equal(a, b)
    d = tmp_path / "imgs"
    d.mkdir()
    for name in ("frame10.png", "frame2.png", "x.txt", "frame3.jpg"):
        (d / name).write_bytes(b"")
    assert sfm.get_sorted_image_files(str(d)) == \
        jsfm.get_sorted_image_files(str(d))
    files = [f"{i}.png" for i in range(30)]
    assert sfm.split_train_test(files, n_views=5) == \
        jsfm.split_train_test(files, n_views=5)
    dm = RNG.uniform(2, 5, (9, 9))
    np.testing.assert_array_equal(sfm.normalize_depth(dm),
                                  jsfm.normalize_depth(dm))
    p1 = RNG.normal(size=(40, 3))
    conf = RNG.uniform(0.5, 2, 40)
    p2 = 1.7 * p1 @ np.linalg.qr(RNG.normal(size=(3, 3)))[0].T + 0.3
    for a, b in zip(sfm.rigid_points_registration(p1, p2, conf),
                    jsfm.rigid_points_registration(p1, p2, conf)):
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-14)
    for a, b in zip(sfm.align_pose(p1, p2), jsfm.align_pose(p1, p2)):
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-14)


def test_load_images_matches_jax(tmp_path):
    write_frames(str(tmp_path), 2, 70, 130)
    got, org = sfm.load_images(str(tmp_path), size=64)
    want, jorg = jsfm.load_images(str(tmp_path), size=64)
    assert org == jorg
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a["img"], b["img"])
        np.testing.assert_array_equal(a["true_shape"], b["true_shape"])
        assert (a["idx"], a["instance"]) == (b["idx"], b["instance"])


def _tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def test_colmap_export_helpers_match_jax(tmp_path):
    n, h, w = 4, 10, 12
    q = RNG.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    w2cs = np.tile(np.eye(4), (n, 1, 1))
    w2cs[:, :3, :3] = np.asarray(jv.quat_to_rotmat(jnp.asarray(q)))
    w2cs[:, :3, 3] = RNG.normal(size=(n, 3))
    imgs = RNG.uniform(0, 1, (n, h, w, 3)).astype(np.float32)
    pts = RNG.normal(size=(n, h, w, 3)).astype(np.float32)
    confs = RNG.uniform(1, 3, (n, h * w)).astype(np.float32)
    masks = RNG.uniform(size=(n, h, w)) > 0.4
    files = [f"/x/{i + 1:04d}.png" for i in range(n)]
    for pkg, root in ((sfm, tmp_path / "t"), (jsfm, tmp_path / "j")):
        _, s0, _ = pkg.init_filestructure(root, n_views=4)
        pkg.save_extrinsic(s0, w2cs, files, ".png")
        pkg.save_intrinsics(s0, np.full(n, 30.5), (120, 100), (n, h, w),
                            save_focals=True)
        np.random.seed(7)           # JAX's downsample draws from np.random
        pkg.save_points3D(s0, imgs, pts, confs, masks, save_all_pts=True,
                          save_txt_path=root, max_pts_num=100)
        pkg.save_images_and_masks(s0, 4, imgs, masks, files, ".png")
        pkg.save_time(root / "time", "pose", 1.25)
    assert _tree(tmp_path / "t") == _tree(tmp_path / "j")
    a, b = tmp_path / "t" / "sparse_4" / "0", tmp_path / "j" / "sparse_4" / "0"
    ti = colmap_io.read_images_binary(str(a / "images.bin"))
    ji = jcolmap._read_images_binary_py(str(b / "images.bin"))
    for k in ji:
        np.testing.assert_allclose(ti[k].qvec, ji[k].qvec, atol=1e-6)
        np.testing.assert_array_equal(ti[k].tvec, ji[k].tvec)
        assert ti[k].name == ji[k].name
    for f in ("cameras.bin", "cameras.txt", "points3D.ply",
              "confidence.npy", "confidence_dsp.npy", "points3D_all.npy",
              "non_scaled_focals.npy"):
        assert (a / f).read_bytes() == (b / f).read_bytes(), f
    for f in _tree(a / "imgs_4") + _tree(a / "overlapping_masks_4"):
        sub = "imgs_4" if (a / "imgs_4" / f).exists() else \
            "overlapping_masks_4"
        np.testing.assert_array_equal(png.read_png(str(a / sub / f)),
                                      png.read_png(str(b / sub / f)))
    for f in ("pts_num.txt", "time/time.txt"):
        assert (tmp_path / "t" / f).read_text() == \
            (tmp_path / "j" / f).read_text()
    os.makedirs(tmp_path / "t" / "sparse" / "0")
    os.replace(a / "images.bin", tmp_path / "t" / "sparse" / "0" /
               "images.bin")
    np.testing.assert_allclose(sfm.read_colmap_gt_pose(str(tmp_path / "t")),
                               jsfm.read_colmap_gt_pose(str(tmp_path / "t")))


# ------------------------------------------------------------ estimators

def test_estimate_poses_vggt_matches_jax(tmp_path, models):
    tm, params = models
    t, j = scene(str(tmp_path / "t")), scene(str(tmp_path / "j"))
    tpose.estimate_poses_vggt(t, model=tm, device="cpu")
    jpose.estimate_poses_vggt(j, params=params, cfg=J_TINY)
    assert _tree(t) == _tree(j)
    for i in range(3):
        a = np.load(os.path.join(t, "camera", f"{i + 1:04d}.npz"))
        b = np.load(os.path.join(j, "camera", f"{i + 1:04d}.npz"))
        for k in ("pose", "intrinsics"):
            assert a[k].dtype == b[k].dtype
            np.testing.assert_allclose(a[k], b[k], err_msg=k, **MODEL_TOL)
    (pa, ca), (pb, cb) = (read_ply_points(os.path.join(r, "points3D.ply"))
                          for r in (t, j))
    np.testing.assert_allclose(pa, pb, **MODEL_TOL)
    np.testing.assert_array_equal(ca, cb)
    # a state_dict in the reference's keys runs the same model
    out = tpose.estimate_poses_vggt(t, model=tm.state_dict(),
                                    cfg=port_cfg(J_TINY), device="cpu")
    assert out["pose_enc"].shape == (3, 9)


def near_identity_cameras(tm):
    """A copy of the model whose camera head predicts poses near the
    identity with fovs near 1.2 rad (its last layer's weights scaled by
    1e-3, its bias at half the target: the head adds two iterations), so
    the frames see each other and the redundancy masks are not empty; and
    the JAX params of that copy."""
    sd = {k: v.clone() for k, v in tm.state_dict().items()}
    sd["camera_head.pose_branch.fc2.weight"] *= 1e-3
    sd["camera_head.pose_branch.fc2.bias"] = torch.tensor(
        [0.0, 0, 0, 0.5, 0, 0, 0, 0.6, 0.6])
    model = tv.VGGT(tm.cfg, device="cpu").eval()
    model.load_state_dict(sd)
    return model, jax.tree_util.tree_map(jnp.asarray, convert_vggt(
        {k: v.numpy() for k, v in sd.items()}))


def test_estimate_poses_dense_init_matches_jax(tmp_path, models,
                                               monkeypatch):
    tm, params = near_identity_cameras(models[0])
    masks, port_masks = {}, sfm.compute_redundancy_masks

    def recorded(pkg, tag):
        inner = pkg.compute_redundancy_masks

        def rec(*args, **kw):
            masks[tag] = (args, kw, inner(*args, **kw))
            return masks[tag][2]
        monkeypatch.setattr(pkg, "compute_redundancy_masks", rec)
    recorded(sfm, "t")
    recorded(jsfm, "j")
    t, j = scene(str(tmp_path / "t"), n=4), scene(str(tmp_path / "j"), n=4)
    assert tpose.get_pose_estimator("mast3r") is \
        tpose.estimate_poses_dense_init
    assert tpose.get_pose_estimator("cut3r") is \
        tpose.estimate_poses_dense_init
    n_t = tpose.estimate_poses_dense_init(t, model=tm, device="cpu")
    jpose.estimate_poses_dense_init(j, params=params, cfg=J_TINY)
    # the masks exactly: end to end, and the port's on JAX's own inputs
    np.testing.assert_array_equal(masks["t"][2], masks["j"][2])
    np.testing.assert_array_equal(
        port_masks(*masks["j"][0], **masks["j"][1]), masks["j"][2])
    assert 0 < masks["j"][2].sum() < masks["j"][2].size
    assert _tree(t) == _tree(j)
    a, b = (os.path.join(r, "sparse_0", "0") for r in (t, j))
    ti = colmap_io.read_images_binary(os.path.join(a, "images.bin"))
    ji = jcolmap._read_images_binary_py(os.path.join(b, "images.bin"))
    for k in ji:
        assert ti[k].name == ji[k].name
        np.testing.assert_allclose(ti[k].qvec, ji[k].qvec, **MODEL_TOL)
        np.testing.assert_allclose(ti[k].tvec, ji[k].tvec, **MODEL_TOL)
    tc = colmap_io.read_cameras_binary(os.path.join(a, "cameras.bin"))
    jc = jcolmap.read_cameras_binary(os.path.join(b, "cameras.bin"))
    for k in jc:
        assert (tc[k].model, tc[k].width, tc[k].height) == \
            (jc[k].model, jc[k].width, jc[k].height) == ("PINHOLE", 60, 40)
        np.testing.assert_allclose(tc[k].params, jc[k].params, **MODEL_TOL)
    for f in ("confidence.npy", "confidence_dsp.npy",
              "non_scaled_focals.npy"):
        x, y = np.load(os.path.join(a, f)), np.load(os.path.join(b, f))
        assert x.shape == y.shape and x.dtype == y.dtype, f
        np.testing.assert_allclose(x, y, err_msg=f, **MODEL_TOL)
    (pa, ca), (pb, cb) = (read_ply_points(os.path.join(r, "points3D.ply"))
                          for r in (a, b))
    assert len(pa) == len(pb) == n_t
    np.testing.assert_allclose(pa, pb, **MODEL_TOL)
    np.testing.assert_array_equal(ca, cb)
    assert open(os.path.join(t, "pts_num.txt")).read() == \
        open(os.path.join(j, "pts_num.txt")).read()


def test_colmap_estimator_needs_its_binary(tmp_path):
    with pytest.raises(RuntimeError, match="colmap"):
        tpose.estimate_poses_colmap(str(tmp_path), colmap_bin="no-colmap")
    with pytest.raises(RuntimeError, match="colmap"):
        jpose.estimate_poses_colmap(str(tmp_path), colmap_bin="no-colmap")
    with pytest.raises(ValueError, match="weights"):
        tpose.estimate_poses_vggt(str(tmp_path), device="cpu")
    with pytest.raises(ValueError):
        tpose.get_pose_estimator("nope")


# ------------------------------------------------------------ normals

def _png_close(a, b):
    x, y = png.read_png(a).astype(int), png.read_png(b).astype(int)
    assert x.shape == y.shape
    diff = np.abs(x - y)
    assert (diff > 0).mean() <= 0.01, (diff > 0).mean()
    return x


def test_generate_normals_and_cli_match_jax(tmp_path, models):
    tm, params = models
    write_frames(str(tmp_path / "t" / "rgb"), 2, 40, 60, seed=3)
    write_frames(str(tmp_path / "j" / "rgb"), 2, 40, 60, seed=3)
    tnormal.generate_normals(str(tmp_path / "t"), model=tm, device="cpu")
    jnormal.generate_normals(str(tmp_path / "j"), params=params, cfg=J_TINY)
    for i in range(2):
        img = _png_close(str(tmp_path / "t" / "normal" / f"{i + 1:04d}.png"),
                         str(tmp_path / "j" / "normal" / f"{i + 1:04d}.png"))
        assert img.shape == (40, 60, 3)
    # the CLI: a torch.save'd state_dict in the reference's keys
    ckpt = str(tmp_path / "model.pt")
    torch.save(tm.state_dict(), ckpt)
    os.rename(tmp_path / "t" / "normal", tmp_path / "t" / "normal_direct")
    cfg = {f.name: getattr(J_TINY, f.name) for f in
           dataclasses.fields(J_TINY) if f.name != "attn_dtype"}
    import json
    assert tnormal.main(["--base_path", str(tmp_path / "t"),
                         "--vggt_checkpoint", ckpt, "--config",
                         json.dumps(cfg), "--device", "cpu"]) == 0
    for i in range(2):
        name = f"{i + 1:04d}.png"
        assert (tmp_path / "t" / "normal" / name).read_bytes() == \
            (tmp_path / "t" / "normal_direct" / name).read_bytes()


# ------------------------------------------------------------ pipeline

def test_pipeline_preprocess_estimates_poses(tmp_path, models):
    tm, params = models
    t, j = scene(str(tmp_path / "t")), scene(str(tmp_path / "j"))
    common = dict(skip_video_process=True,
                  skip_lang_feature_extraction=True)
    tp = FieldConstructionPipeline(PipelinePaths(data_path=t, **common),
                                   device="cpu")
    tp.vggt, tp.vggt_cfg = tm.state_dict(), port_cfg(J_TINY)
    tp.preprocess()
    jp = JPipeline(JPaths(data_path=j, **common))
    jp.vggt_params, jp.vggt_cfg = params, J_TINY
    jp.preprocess()
    assert _tree(t) == _tree(j)
    for i in range(3):
        a = np.load(os.path.join(t, "camera", f"{i + 1:04d}.npz"))
        b = np.load(os.path.join(j, "camera", f"{i + 1:04d}.npz"))
        np.testing.assert_allclose(a["pose"], b["pose"], **MODEL_TOL)
    # the dense-init estimator through the same switch
    tp.pose_estimator = "cut3r"
    tp.estimate_poses()
    assert os.path.exists(os.path.join(t, "sparse_0", "0", "points3D.ply"))
