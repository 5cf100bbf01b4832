"""The field stage's file input and output in the PyTorch port against PIL
and the JAX package (CPU): the PNG codec and PIL's bicubic resize
(``utils/png``), the camera image and normal readers, the two former PIL
sites of the video path, the COLMAP readers and writers against the JAX
package's and its native parser, the scene readers (colmap, CUT3R,
blender) through ``load_scene``, ``post_pose_process`` and the
open-vocabulary metrics."""
import json
import os
import struct
import zlib

import numpy as np
import pytest
from PIL import Image
from test_torch_threads import few_torch_threads  # noqa: F401

from langscenex_tpu import native as jnative
from langscenex_tpu.eval import open_vocab as jov
from langscenex_tpu.scene import cameras as jcameras
from langscenex_tpu.scene import colmap_io as jcol
from langscenex_tpu.scene import dataset_readers as jdr
from langscenex_tpu.utils import camera_paths as jpaths
from langscenex_tpu_torch import video_inference
from langscenex_tpu_torch.eval import open_vocab as tov
from langscenex_tpu_torch.models.cogvideox import datasets
from langscenex_tpu_torch.scene import cameras as tcameras
from langscenex_tpu_torch.scene import colmap_io as tcol
from langscenex_tpu_torch.scene import dataset_readers as tdr
from langscenex_tpu_torch.utils import camera_paths as tpaths
from langscenex_tpu_torch.utils import png

RNG = np.random.default_rng(0)


# ---- PNG codec --------------------------------------------------------------

def _smooth(h, w, c, seed=0):
    """A noisy gradient: PIL's encoder picks every filter type for it."""
    rng = np.random.default_rng(seed)
    x = np.linspace(0, 255, w)[None, :, None] * np.ones((h, 1, c))
    x = x + np.linspace(0, 60, h)[:, None, None]
    return (x + rng.normal(0, 4, x.shape)).clip(0, 255).astype(np.uint8)


@pytest.mark.parametrize("mode,shape", [("L", (48, 64)), ("LA", (48, 64, 2)),
                                        ("RGB", (48, 64, 3)),
                                        ("RGBA", (48, 64, 4))])
def test_png_round_trips_through_pil(tmp_path, mode, shape):
    # exact both ways: PIL's PNG (all five filter types) decodes in the
    # port, the port's PNG decodes in PIL
    a = _smooth(48, 64, 1 if len(shape) == 2 else shape[2])
    a = a[..., 0] if len(shape) == 2 else a
    Image.fromarray(a, mode).save(tmp_path / "pil.png", optimize=True)
    raw = zlib.decompress(b"".join(
        body for tag, body in png._chunks(
            (tmp_path / "pil.png").read_bytes(), "") if tag == b"IDAT"))
    stride = 64 * (1 if len(shape) == 2 else shape[2]) + 1
    assert len(set(raw[::stride])) >= 2          # more than one filter used
    np.testing.assert_array_equal(png.read_png(str(tmp_path / "pil.png")), a)
    png.write_png(str(tmp_path / "port.png"), a)
    with Image.open(tmp_path / "port.png") as im:
        assert im.mode == mode
        np.testing.assert_array_equal(np.asarray(im), a)
    assert png.png_size(str(tmp_path / "port.png")) == (64, 48)


@pytest.mark.parametrize("colors", [2, 4, 16, 200])
def test_palette_png_decodes_as_pil_converts(tmp_path, colors):
    # PIL writes 1-, 2-, 4- and 8-bit palettes; with a tRNS chunk the
    # port gives RGBA, as PIL's convert("RGBA")
    rgb = RNG.integers(0, 256, (30, 41, 3)).astype(np.uint8)
    im = Image.fromarray(rgb).quantize(colors)
    im.save(tmp_path / "p.png")
    with Image.open(tmp_path / "p.png") as ref:
        np.testing.assert_array_equal(png.read_png(str(tmp_path / "p.png")),
                                      np.asarray(ref.convert("RGB")))
    im.save(tmp_path / "t.png", transparency=1)
    with Image.open(tmp_path / "t.png") as ref:
        np.testing.assert_array_equal(png.read_png(str(tmp_path / "t.png")),
                                      np.asarray(ref.convert("RGBA")))
    # the port's palette writer
    idx = RNG.integers(0, colors, (30, 41)).astype(np.uint8)
    pal = RNG.integers(0, 256, (colors, 3)).astype(np.uint8)
    png.write_png(str(tmp_path / "w.png"), idx, palette=pal)
    with Image.open(tmp_path / "w.png") as ref:
        assert ref.mode == "P"
        np.testing.assert_array_equal(np.asarray(ref.convert("RGB")),
                                      pal[idx])


def test_one_bit_gray_and_to_rgb(tmp_path):
    g = (RNG.integers(0, 2, (33, 19)) * 255).astype(np.uint8)
    Image.fromarray(g).convert("1").save(tmp_path / "b.png")
    with Image.open(tmp_path / "b.png") as ref:
        np.testing.assert_array_equal(png.read_png(str(tmp_path / "b.png")),
                                      np.asarray(ref.convert("L")))
        np.testing.assert_array_equal(
            png.to_rgb(png.read_png(str(tmp_path / "b.png"))),
            np.asarray(ref.convert("RGB")))
    la = RNG.integers(0, 256, (5, 6, 2)).astype(np.uint8)
    np.testing.assert_array_equal(
        png.to_rgb(la), np.asarray(Image.fromarray(la, "LA").convert("RGB")))


def _raw_png(path, depth, ctype, interlace, body=b"\0" * 8):
    ihdr = struct.pack(">IIBBBBB", 2, 2, depth, ctype, 0, 0, interlace)
    path.write_bytes(png.SIGNATURE + png._chunk(b"IHDR", ihdr)
                     + png._chunk(b"IDAT", zlib.compress(body))
                     + png._chunk(b"IEND", b""))


def test_unread_formats_raise_value_error(tmp_path):
    _raw_png(tmp_path / "i.png", 8, 0, 1)
    with pytest.raises(ValueError, match="interlaced"):
        png.read_png(str(tmp_path / "i.png"))
    Image.fromarray(RNG.integers(0, 65535, (4, 5)).astype(np.uint16)).save(
        tmp_path / "d.png")
    with pytest.raises(ValueError, match="16-bit"):
        png.read_png(str(tmp_path / "d.png"))
    Image.fromarray(_smooth(8, 8, 3)).save(tmp_path / "j.jpg")
    with pytest.raises(ValueError, match="JPEG"):
        png.read_png(str(tmp_path / "j.jpg"))
    with pytest.raises(ValueError, match="JPEG"):
        datasets.load_image(str(tmp_path / "j.jpg"), (8, 8))


@pytest.mark.parametrize("size", [(32, 24), (100, 70), (64, 20), (13, 91),
                                  (64, 48)])
def test_resize_bicubic_matches_pil(size):
    # the tolerance is 1/255 (one 8-bit level); the integer arithmetic is
    # PIL's, so the result is in fact equal
    img = _smooth(48, 64, 3, seed=3)
    img[::7] = RNG.integers(0, 256, img[::7].shape)        # sharp rows
    ref = np.asarray(Image.fromarray(img).resize(size)).astype(int)
    got = png.resize_bicubic(img, size).astype(int)
    assert np.abs(got - ref).max() <= 1
    gray = img[..., 0]
    ref = np.asarray(Image.fromarray(gray).resize(size)).astype(int)
    assert np.abs(png.resize_bicubic(gray, size).astype(int) - ref).max() <= 1


def _camera_kwargs(path, w, h):
    return dict(uid=0, colmap_id=1, R=np.eye(3), T=np.zeros(3), fovx=1.0,
                fovy=0.8, width=w, height=h, image_name="0001",
                image_path=str(path))


@pytest.mark.parametrize("size", [(64, 48), (40, 30), (96, 72)])
def test_camera_load_image_matches_jax(tmp_path, size):
    # same size: equal; after a resize: within 1/255
    Image.fromarray(_smooth(48, 64, 3)).save(tmp_path / "0001.png")
    kw = _camera_kwargs(tmp_path / "0001.png", *size)
    ji, jg = jcameras.Camera(**kw).load_image()
    ti, tg = tcameras.Camera(**kw).load_image()
    tol = 0 if size == (64, 48) else 1 / 255 + 1e-7
    np.testing.assert_allclose(ti, ji, atol=tol, rtol=0)
    np.testing.assert_allclose(tg, jg, atol=tol, rtol=0)
    assert ti.dtype == np.float32 and ti.shape == (3, size[1], size[0])


def test_camera_load_normal_matches_jax(tmp_path):
    (tmp_path / "input").mkdir()
    (tmp_path / "normal").mkdir()
    Image.fromarray(_smooth(48, 64, 3)).save(tmp_path / "input" / "0001.png")
    n = RNG.normal(size=(48, 64, 3))
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    n[:4] *= 2.0                                  # an invalid band
    Image.fromarray(((n * 0.5 + 0.5).clip(0, 1) * 255).astype(np.uint8)
                    ).save(tmp_path / "normal" / "0001.png")
    for size in ((64, 48), (32, 24)):
        kw = _camera_kwargs(tmp_path / "input" / "0001.png", *size)
        rot = np.linalg.qr(RNG.normal(size=(3, 3)))[0]
        kw["R"] = rot
        jn, jm = jcameras.Camera(**kw).load_normal()
        tn, tm = tcameras.Camera(**kw).load_normal()
        np.testing.assert_allclose(tn, jn, atol=1e-6, rtol=0)
        np.testing.assert_array_equal(tm, jm)


def test_video_path_reads_and_writes_without_pil(tmp_path):
    # datasets.load_image: PIL's convert("RGB").resize, exactly; and
    # save_video_frames' PNGs decode in PIL to (x + 1) / 2 * 255 truncated
    rgba = np.concatenate([_smooth(24, 36, 3), np.full((24, 36, 1), 200,
                                                       np.uint8)], -1)
    Image.fromarray(rgba, "RGBA").save(tmp_path / "k.png")
    with Image.open(tmp_path / "k.png") as im:
        ref = np.asarray(im.convert("RGB").resize((20, 14)), np.float32)
    np.testing.assert_array_equal(
        datasets.load_image(str(tmp_path / "k.png"), (14, 20)),
        ref.transpose(2, 0, 1) / 127.5 - 1.0)
    video = RNG.uniform(-1.1, 1.1, (3, 3, 10, 12)).astype(np.float32)
    video_inference.save_video_frames(video, str(tmp_path / "frames"))
    for t in range(3):
        with Image.open(tmp_path / "frames" / f"{t + 1:04d}.png") as im:
            want = (np.clip((video[t].transpose(1, 2, 0) + 1) / 2, 0, 1)
                    * 255).astype(np.uint8)
            np.testing.assert_array_equal(np.asarray(im), want)


# ---- COLMAP -----------------------------------------------------------------

def _colmap_model(n_img=4, n_pts=50):
    cams = {1: jcol.ColmapCamera(1, "PINHOLE", 64, 48,
                                 np.array([60.0, 61.0, 32.0, 24.0])),
            2: jcol.ColmapCamera(2, "SIMPLE_PINHOLE", 64, 48,
                                 np.array([58.0, 32.0, 24.0]))}
    imgs = {}
    for i in range(1, n_img + 1):
        q = RNG.normal(size=4)
        imgs[i] = jcol.ColmapImage(i, q / np.linalg.norm(q),
                                   RNG.normal(size=3), 1 + i % 2,
                                   f"{i:04d}.png")
    xyz = RNG.normal(size=(n_pts, 3))
    rgb = RNG.integers(0, 256, (n_pts, 3))
    err = RNG.uniform(0, 2, n_pts)
    return cams, imgs, xyz, rgb, err


def _same_images(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert (a[k].id, a[k].camera_id, a[k].name) == \
            (b[k].id, b[k].camera_id, b[k].name)
        np.testing.assert_array_equal(a[k].qvec, b[k].qvec)
        np.testing.assert_array_equal(a[k].tvec, b[k].tvec)


def _same_cameras(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert (a[k].id, a[k].model, a[k].width, a[k].height) == \
            (b[k].id, b[k].model, b[k].width, b[k].height)
        np.testing.assert_array_equal(a[k].params, b[k].params)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_colmap_binary_round_trips_across_packages(tmp_path, writer):
    cams, imgs, xyz, rgb, err = _colmap_model()
    w, r = (tcol, jcol) if writer == "port" else (jcol, tcol)
    w.write_cameras_binary(cams, str(tmp_path / "cameras.bin"))
    w.write_images_binary(imgs, str(tmp_path / "images.bin"))
    w.write_points3d_binary(str(tmp_path / "points3D.bin"), xyz, rgb, err)
    _same_cameras(r.read_cameras_binary(str(tmp_path / "cameras.bin")), cams)
    _same_images(r.read_images_binary(str(tmp_path / "images.bin")), imgs)
    for got, want in zip(r.read_points3d_binary(str(tmp_path /
                                                    "points3D.bin")),
                         (xyz, rgb, err.reshape(-1, 1))):
        np.testing.assert_array_equal(got, want)
    # the writers agree byte for byte
    for name in ("cameras.bin", "images.bin", "points3D.bin"):
        os.rename(tmp_path / name, tmp_path / ("a_" + name))
    r.write_cameras_binary(cams, str(tmp_path / "cameras.bin"))
    r.write_images_binary(imgs, str(tmp_path / "images.bin"))
    r.write_points3d_binary(str(tmp_path / "points3D.bin"), xyz, rgb, err)
    for name in ("cameras.bin", "images.bin", "points3D.bin"):
        assert (tmp_path / name).read_bytes() == \
            (tmp_path / ("a_" + name)).read_bytes(), name


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_colmap_text_round_trips_across_packages(tmp_path, writer):
    cams, imgs, xyz, rgb, err = _colmap_model()
    w, r = (tcol, jcol) if writer == "port" else (jcol, tcol)
    w.write_cameras_text(cams, str(tmp_path / "cameras.txt"))
    w.write_images_text(imgs, str(tmp_path / "images.txt"))
    w.write_points3d_text(str(tmp_path / "points3D.txt"), xyz, rgb, err)
    _same_cameras(r.read_cameras_text(str(tmp_path / "cameras.txt")), cams)
    _same_images(r.read_images_text(str(tmp_path / "images.txt")), imgs)
    got = r.read_points3d_text(str(tmp_path / "points3D.txt"))
    want = jcol.read_points3d_text(str(tmp_path / "points3D.txt"))
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(g, w_)
        assert g.dtype == w_.dtype


def _tracked_files(tmp_path, n_img=5, n_pts=300):
    """images.bin and points3D.bin with 2D points and tracks, which the
    writers leave empty."""
    with open(tmp_path / "images.bin", "wb") as f:
        f.write(struct.pack("<Q", n_img))
        for i in range(n_img):
            f.write(struct.pack("<i4d3di", 10 + i, *RNG.normal(size=7),
                                1 + i % 2))
            f.write(f"frame_{i:03d}.png".encode() + b"\0")
            npts = int(RNG.integers(0, 6))
            f.write(struct.pack("<Q", npts))
            f.write(RNG.normal(size=3 * npts).tobytes())
    with open(tmp_path / "points3D.bin", "wb") as f:
        f.write(struct.pack("<Q", n_pts))
        for i in range(n_pts):
            f.write(struct.pack("<Q3d3Bd", i + 1, *RNG.normal(size=3),
                                *RNG.integers(0, 256, 3),
                                float(RNG.uniform())))
            tl = int(RNG.integers(0, 5))
            f.write(struct.pack("<Q", tl))
            f.write(RNG.integers(0, 100, 2 * tl).astype("<i4").tobytes())


def test_numpy_parser_equals_native_arrays(tmp_path):
    # the JAX package's C++ parser (built with g++ here) and the port's
    # numpy parser, on files with tracks and without
    if jnative.get_lib() is None:
        pytest.fail("the JAX package's native parser did not build")
    _tracked_files(tmp_path)
    got = tcol.read_points3d_binary(str(tmp_path / "points3D.bin"))
    want = jnative.read_points3d_binary(str(tmp_path / "points3D.bin"))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype and g.shape == w.shape
    imgs = tcol.read_images_binary(str(tmp_path / "images.bin"))
    nat = jnative.read_images_binary(str(tmp_path / "images.bin"))
    assert sorted(imgs) == sorted(nat)
    for k, (q, t, cid, name) in nat.items():
        np.testing.assert_array_equal(imgs[k].qvec, q)
        np.testing.assert_array_equal(imgs[k].tvec, t)
        assert (imgs[k].camera_id, imgs[k].name) == (cid, name)
    _, _, xyz, rgb, err = _colmap_model(n_pts=64)
    jcol.write_points3d_binary(str(tmp_path / "flat.bin"), xyz, rgb, err)
    for g, w in zip(tcol.read_points3d_binary(str(tmp_path / "flat.bin")),
                    jnative.read_points3d_binary(str(tmp_path / "flat.bin"))):
        np.testing.assert_array_equal(g, w)
    (tmp_path / "cut.bin").write_bytes(
        (tmp_path / "points3D.bin").read_bytes()[:-5])
    with pytest.raises(ValueError, match="truncated"):
        tcol.read_points3d_binary(str(tmp_path / "cut.bin"))


# ---- scene readers ----------------------------------------------------------

def _write_frames(d, n, w=64, h=48, names=None):
    os.makedirs(d, exist_ok=True)
    for i in range(n):
        name = names[i] if names else f"{i + 1:04d}.png"
        Image.fromarray(_smooth(h, w, 3, seed=i)).save(os.path.join(d, name))


def _colmap_scene(root):
    cams, imgs, xyz, rgb, err = _colmap_model(n_img=6, n_pts=120)
    for im in imgs.values():                 # centres within 1 of each other
        im.tvec = RNG.uniform(-0.3, 0.3, 3)
    sparse = os.path.join(root, "sparse", "0")
    os.makedirs(sparse)
    jcol.write_cameras_binary(cams, os.path.join(sparse, "cameras.bin"))
    jcol.write_images_binary(imgs, os.path.join(sparse, "images.bin"))
    jcol.write_points3d_binary(os.path.join(sparse, "points3D.bin"), xyz,
                               rgb, err)
    _write_frames(os.path.join(root, "images"), 6)


def _cut3r_scene(root, n=6):
    _write_frames(os.path.join(root, "input"), n)
    os.makedirs(os.path.join(root, "camera"))
    for i in range(n):
        pose = np.eye(4)
        pose[:3, :3] = np.linalg.qr(np.eye(3) + 0.05 * RNG.normal(
            size=(3, 3)))[0]
        pose[:3, 3] = [0.05 * i, 0.02 * i, 0.0]
        K = np.array([[60.0, 0, 32], [0, 60.0, 24], [0, 0, 1]])
        np.savez(os.path.join(root, "camera", f"{i + 1:04d}.npz"), pose=pose,
                 intrinsics=K)
    jdr.write_ply_points(os.path.join(root, "points3D.ply"),
                         RNG.normal(size=(150, 3)).astype(np.float32),
                         RNG.uniform(0, 1, (150, 3)).astype(np.float32))


def _blender_scene(root, with_ply):
    names = [f"r_{i}.png" for i in range(4)]
    _write_frames(os.path.join(root, "train"), 3, 40, 30, names[:3])
    _write_frames(os.path.join(root, "test"), 1, 40, 30, names[3:])
    for split, idx in (("train", range(3)), ("test", range(3, 4))):
        frames = []
        for i in idx:
            c2w = np.eye(4)
            c2w[:3, 3] = [0.1 * i, 0.0, 4.0]
            frames.append({"file_path": f"./{split}/r_{i}",
                           "transform_matrix": c2w.tolist()})
        with open(os.path.join(root, f"transforms_{split}.json"), "w") as f:
            json.dump({"camera_angle_x": 0.69, "frames": frames}, f)
    if with_ply:
        jdr.write_ply_points(os.path.join(root, "points3d.ply"),
                             RNG.normal(size=(90, 3)).astype(np.float32))


def _same_scene(t, j):
    assert len(t.cameras) == len(j.cameras)
    for a, b in zip(t.cameras, j.cameras):
        assert (a.uid, a.colmap_id, a.width, a.height, a.image_name,
                a.image_path) == (b.uid, b.colmap_id, b.width, b.height,
                                  b.image_name, b.image_path)
        np.testing.assert_array_equal(a.R, b.R)
        np.testing.assert_array_equal(a.T, b.T)
        assert (a.fovx, a.fovy) == (b.fovx, b.fovy)
        assert a.nearest_id == b.nearest_id
    np.testing.assert_array_equal(t.points, j.points)
    np.testing.assert_array_equal(t.colors, j.colors)
    assert t.nerf_norm_radius == j.nerf_norm_radius
    np.testing.assert_array_equal(t.nerf_norm_translate,
                                  j.nerf_norm_translate)


@pytest.mark.parametrize("kind", ["colmap", "cut3r", "blender",
                                  "blender_ply"])
def test_load_scene_matches_jax(tmp_path, kind):
    # the same cameras (R, T, fov, size, name, order after the seeded
    # shuffle, nearest sets), points, colours and extent, exactly
    root = str(tmp_path)
    if kind == "colmap":
        _colmap_scene(root)
    elif kind == "cut3r":
        _cut3r_scene(root)
    else:
        _blender_scene(root, with_ply=kind == "blender_ply")
    for shuffle, seed in ((True, 0), (True, 5), (False, 0)):
        t = tdr.load_scene(root, shuffle=shuffle, seed=seed, max_dis=10.0)
        j = jdr.load_scene(root, shuffle=shuffle, seed=seed, max_dis=10.0)
        _same_scene(t, j)
    if kind.startswith("blender"):
        assert (t.cameras[0].width, t.cameras[0].height) == (40, 30)
    if kind != "blender":
        # the readers' images load as JAX's
        np.testing.assert_array_equal(t.cameras[0].load_image()[0],
                                      j.cameras[0].load_image()[0])


def test_ply_points_round_trip(tmp_path):
    pts = RNG.normal(size=(40, 3)).astype(np.float32)
    cols = RNG.uniform(0, 1, (40, 3)).astype(np.float32)
    tdr.write_ply_points(str(tmp_path / "a.ply"), pts, cols)
    jdr.write_ply_points(str(tmp_path / "b.ply"), pts, cols)
    assert (tmp_path / "a.ply").read_bytes() == (tmp_path / "b.ply"
                                                 ).read_bytes()
    for g, w in zip(tdr.read_ply_points(str(tmp_path / "a.ply")),
                    jdr.read_ply_points(str(tmp_path / "a.ply"))):
        np.testing.assert_array_equal(g, w)


# ---- camera paths, open-vocabulary metrics -----------------------------------

def test_post_pose_process_matches_jax(tmp_path):
    import jax.numpy as jnp
    from langscenex_tpu.ops.quat import tensor_from_camera
    _cut3r_scene(str(tmp_path), n=3)
    ex = str(tmp_path / "camera" / "0001.npz")
    w2c = np.stack([np.linalg.inv(np.load(tmp_path / "camera" /
                                          f"{i + 1:04d}.npz")["pose"])
                    for i in range(3)]).astype(np.float32)
    qt = np.asarray(tensor_from_camera(jnp.asarray(w2c)))
    tpaths.post_pose_process(qt, ex, str(tmp_path / "t"))
    jpaths.post_pose_process(qt, ex, str(tmp_path / "j"))
    for i in range(3):
        a = np.load(tmp_path / "t" / f"{i + 1:04d}.npz")
        b = np.load(tmp_path / "j" / f"{i + 1:04d}.npz")
        np.testing.assert_allclose(a["pose"], b["pose"], atol=1e-6, rtol=0)
        np.testing.assert_array_equal(a["intrinsics"], b["intrinsics"])


def test_open_vocab_metrics_match_jax():
    lang = [RNG.normal(size=(3, 12, 16)).astype(np.float32) for _ in range(2)]
    lang[0][:, :3] *= 0.01                              # uncovered rows
    gt = [RNG.integers(-1, 3, (12, 16)) for _ in range(2)]
    codes = RNG.normal(size=(3, 3)).astype(np.float32)
    rel_t = tov.relevancy_maps(lang[0], codes)
    np.testing.assert_array_equal(rel_t, jov.relevancy_maps(lang[0], codes))
    np.testing.assert_array_equal(tov.predict_masks(rel_t, 0.3),
                                  jov.predict_masks(rel_t, 0.3))
    assert tov.eval_open_vocab(lang, gt, codes, 0.2) == \
        jov.eval_open_vocab(lang, gt, codes, 0.2)
    with pytest.raises(NotImplementedError, match="D1"):
        tov.embed_queries(["a chair"], None, None, None)
    with pytest.raises(NotImplementedError, match="D1"):
        tov.encode_queries_to_lang3(np.zeros((1, 768)), None)
