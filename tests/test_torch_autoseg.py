"""The auto-seg stage of the PyTorch port vs the JAX package on the CPU:
``MaskAligner.run`` on the tiny SAM2 stack (the same seg maps and
colours, exactly), ``save_outputs`` (the same files), both CLIs on the
same PNG frames with the same tiny stack behind ``build_from_checkpoints``
(the same outputs: the port reads and resizes the frames and resizes the
id maps without PIL, exactly as PIL does), the nearest resize against
Pillow, ``build_from_checkpoints`` reading ``torch.save``d checkpoints in
the reference's two layouts, and the frame loader's refusals."""
import os

import numpy as np
import pytest
import torch
from PIL import Image
from test_torch_threads import few_torch_threads  # noqa: F401

from langscenex_tpu.autoseg import __main__ as jcli
from langscenex_tpu.autoseg import mask_align as jalign
from langscenex_tpu.models.sam2 import amg as jamg
from langscenex_tpu.models.sam2 import model as jmodel
from langscenex_tpu_torch.autoseg import __main__ as cli
from langscenex_tpu_torch.autoseg import mask_align
from langscenex_tpu_torch.models import sam1
from langscenex_tpu_torch.models.sam2 import amg, model
from langscenex_tpu_torch.utils import png
from test_torch_sam import T_SAM1, T_SAM2, sam2_pair

AMG_KW = dict(points_per_side=2, points_per_batch=4, pred_iou_thresh=-1e9,
              stability_score_thresh=-1e9, min_mask_area=0)
ALIGN_KW = dict(detect_stride=1, max_objects=4, new_obj_min_area=4,
                postnms_score=-1e9)


@pytest.fixture(scope="module")
def stacks():
    """(JAX generator, JAX predictor), (port generator, port predictor),
    the same tiny SAM2 weights behind both."""
    jm, params, tm = sam2_pair(seed=3)
    return ((jamg.AutomaticMaskGenerator(jm, params,
                                         jamg.AMGConfig(**AMG_KW)),
             jmodel.SAM2VideoPredictor(jm, params)),
            (amg.AutomaticMaskGenerator(tm, amg.AMGConfig(**AMG_KW)),
             model.SAM2VideoPredictor(tm)))


def test_mask_aligner_run_matches_jax(stacks, tmp_path):
    frames = np.random.default_rng(0).uniform(0, 1, (3, 3, 64, 64)).astype(
        np.float32)
    (jg, jp), (tg, tp) = stacks
    want_maps, want_cols = jalign.MaskAligner(
        jg, jp, jalign.MaskAlignConfig(**ALIGN_KW)).run(frames)
    got_maps, got_cols = mask_align.MaskAligner(
        tg, tp, mask_align.MaskAlignConfig(**ALIGN_KW)).run(frames)
    assert got_maps.dtype == np.int32 and got_maps.shape == (3, 64, 64)
    assert (want_maps >= 0).any()
    np.testing.assert_array_equal(got_maps, want_maps)
    np.testing.assert_array_equal(got_cols, want_cols)

    jalign.save_outputs(want_maps, want_cols, str(tmp_path / "jax"))
    mask_align.save_outputs(got_maps, got_cols, str(tmp_path / "port"))
    _same_outputs(tmp_path / "port", tmp_path / "jax")


def _same_outputs(got_dir, want_dir):
    names = sorted(os.listdir(want_dir))
    assert sorted(os.listdir(got_dir)) == names
    for n in names:
        if n.endswith(".npy"):
            np.testing.assert_array_equal(np.load(got_dir / n),
                                          np.load(want_dir / n))
        else:
            np.testing.assert_array_equal(
                png.read_png(str(got_dir / n)),
                np.asarray(Image.open(want_dir / n)))


def test_colors_match_jax():
    for n in (1, 7, 64):
        np.testing.assert_array_equal(mask_align.generate_distinct_colors(n),
                                      jalign.generate_distinct_colors(n))


def test_cli_on_png_frames_matches_jax(stacks, tmp_path, monkeypatch):
    rng = np.random.default_rng(1)
    frames = tmp_path / "rgb"
    frames.mkdir()
    for i in range(3):
        Image.fromarray(rng.integers(0, 256, (48, 80, 3), np.uint8)).save(
            frames / f"{i:04d}.png")
    (jg, jp), (tg, tp) = stacks
    monkeypatch.setattr(jalign, "build_from_checkpoints",
                        lambda *a, **k: (jg, jp))
    monkeypatch.setattr(mask_align, "build_from_checkpoints",
                        lambda *a, **k: (tg, tp))
    common = ["--sam1_checkpoint", "a.pth", "--sam2_checkpoint", "b.pt",
              "--video_path", str(frames), "--detect_stride", "1",
              "--image_size", "64"]
    assert jcli.main(common + ["--output_dir", str(tmp_path / "jax")]) == 0
    assert cli.main(common + ["--output_dir", str(tmp_path / "port"),
                              "--device", "cpu"]) == 0
    _same_outputs(tmp_path / "port", tmp_path / "jax")
    assert np.load(tmp_path / "port" / "0001_s.npy").shape == (48, 80)

    got, hw = cli.load_frames(str(frames), 64)
    want, jhw = jcli.load_frames(str(frames), 64)
    assert hw == jhw
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("hw,size", [((64, 64), (80, 48)),
                                     ((1024, 1024), (720, 480)),
                                     ((37, 91), (200, 13))])
def test_resize_nearest_matches_pillow(hw, size):
    ids = np.random.default_rng(2).integers(-1, 64, hw).astype(np.int32)
    want = np.asarray(Image.fromarray(ids, mode="I").resize(size,
                                                            Image.NEAREST))
    np.testing.assert_array_equal(png.resize_nearest(ids, size), want)
    np.testing.assert_array_equal(cli.resize_id_maps(ids[None], size[::-1]),
                                  want[None])


def test_build_from_checkpoints(tmp_path, monkeypatch):
    m1 = sam1.init_sam1_params(sam1.SAM1(T_SAM1, device="cpu"), 4)
    m2 = model.init_sam2_params(model.SAM2(T_SAM2, device="cpu"), 5)
    torch.save(m1.state_dict(), tmp_path / "sam1.pth")
    torch.save({"model": m2.state_dict()}, tmp_path / "sam2.pt")
    monkeypatch.setattr(sam1, "SAM1Config", lambda: T_SAM1)
    monkeypatch.setattr(model, "SAM2Config", lambda image_size: T_SAM2)
    g, p = mask_align.build_from_checkpoints(
        str(tmp_path / "sam1.pth"), str(tmp_path / "sam2.pt"),
        image_size=64, device="cpu")
    for got, want in ((g.model, m1), (p.model, m2)):
        sd = want.state_dict()
        for k, v in got.state_dict().items():
            assert torch.equal(v, sd[k]), k


def test_frame_loader_refusals(tmp_path, monkeypatch):
    d = tmp_path / "jpg"
    d.mkdir()
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(d / "0001.jpg")
    with pytest.raises(ValueError):
        cli.load_frames(str(d), 16)
    monkeypatch.setattr(cli.shutil, "which", lambda name: None)
    video = tmp_path / "clip.mp4"
    video.write_bytes(b"\0" * 16)
    with pytest.raises(RuntimeError, match="ffmpeg"):
        cli.load_frames(str(video), 16)
