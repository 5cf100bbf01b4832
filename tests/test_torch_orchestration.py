"""The PyTorch port's orchestration vs the JAX package's (CPU):
``train_all.scene_argv`` equal to JAX's and ``main`` over two tiny scenes
through the port's ``entry_point.run`` (one scene failing: rc 1, and
``--stop-on-error`` raises); ``convert_cli.verify`` (missing keys,
unexpected keys, shape drift; a real port state_dict passes) and every
family's full-size value count against JAX's ``expected_shapes`` total,
with the layout differences stated in the module; and the port's
``quick_start --tiny`` chain on the CPU, held to the filesystem contract
of the JAX package's tests/test_quick_start_chain.py. There is no
whole-chain numeric parity: each side seeds its random models in its own
way, and each stage's parity is held by its own tests. About 60
worker-seconds (the chain about 20, JAX's traced full-size inits about
30)."""
import os

import numpy as np
import pytest
import torch
from test_torch_threads import few_torch_threads  # noqa: F401

from langscenex_tpu import convert_cli as jconvert
from langscenex_tpu import train_all as jtrain_all
from langscenex_tpu_torch import convert_cli, quick_start, train_all
from langscenex_tpu_torch.scene.dataset_readers import write_ply_points
from langscenex_tpu_torch.utils.png import write_png

W, H = 48, 32


def test_scene_argv_equals_jax():
    for extra in ([], ["gaussian.opt.max_geo_iter=99", "x.y=1"],
                  ["pipeline.selection=True", "device=cpu"]):
        assert (train_all.scene_argv("kitchen", "outputs", "fc/data",
                                     "fc/out", extra)
                == jtrain_all.scene_argv("kitchen", "outputs", "fc/data",
                                         "fc/out", extra))


def _scene(root, n=2):
    """A tiny CUT3R-contract scene (input PNGs, camera npz, points)."""
    rng = np.random.default_rng(0)
    os.makedirs(os.path.join(root, "input"))
    os.makedirs(os.path.join(root, "camera"))
    pts = rng.uniform(-0.5, 0.5, (150, 3)).astype(np.float32)
    pts[:, 2] += 3.0
    write_ply_points(os.path.join(root, "points3D.ply"), pts,
                     rng.uniform(0, 1, (150, 3)).astype(np.float32))
    for i in range(n):
        write_png(os.path.join(root, "input", f"{i + 1:04d}.png"),
                  (rng.uniform(0, 1, (H, W, 3)) * 255).astype(np.uint8))
        pose = np.eye(4)
        pose[:3, 3] = [0.05 * i, 0, 0]
        K = np.array([[50.0, 0, W / 2], [0, 50.0, H / 2], [0, 0, 1]])
        np.savez(os.path.join(root, "camera", f"{i + 1:04d}.npz"),
                 pose=pose, intrinsics=K)


# a short field run: 3 iterations of the image phase, no extraction
EXTRA = ["device=cpu", "gaussian.opt.iterations=3",
         "gaussian.opt.max_geo_iter=100", "gaussian.opt.densify_from_iter=10000",
         "gaussian.opt.single_view_weight_from_iter=10000",
         "gaussian.opt.multi_view_weight_from_iter=10000",
         "gaussian.opt.lang_loss_start_iter=10000",
         "gaussian.opt.loss_obj_3d=False", "gaussian.opt.grouping_loss=False",
         "gaussian.dataset.sh_degree=1",
         "pipeline.skip_video_process=true",
         "pipeline.skip_pose_estimate=true",
         "pipeline.skip_lang_feature_extraction=true"]


def test_train_all_runs_scenes_and_reports_failures(tmp_path, monkeypatch):
    data = tmp_path / "data"
    _scene(str(data / "a"))
    runs = []
    from langscenex_tpu_torch import entry_point
    real_run = entry_point.run

    def recording_run(argv):
        runs.append(argv)
        return real_run(argv)
    monkeypatch.setattr(entry_point, "run", recording_run)
    argv = ["--scenes", "a,missing", "--videos", str(tmp_path / "v"),
            "--data", str(data), "--out", str(tmp_path / "o")] + EXTRA
    assert train_all.main(argv) == 1             # "missing" has no scene
    assert len(runs) == 2 and all("device=cpu" in r for r in runs)
    assert runs[0][0] == "mode=train"
    # scene a trained on the CPU and wrote its snapshot
    assert (data / "a" / "output" / "point_cloud" / "iteration_3"
            / "point_cloud.ply").exists()
    with pytest.raises(Exception):
        train_all.main(["--scenes", "missing,a", "--stop-on-error",
                        "--data", str(data)] + EXTRA)
    assert len(runs) == 3                        # stopped at the first
    # the batch default pipeline.selection=False is a valid override; True
    # is refused by the pipeline
    assert train_all.main(["--scenes", "a", "--data", str(data), "--out",
                           str(tmp_path / "o"), "pipeline.selection=True"]
                          + EXTRA) == 1


def test_convert_verify_catches_missing_extra_and_drift():
    from langscenex_tpu_torch.models.autoencoder import Autoencoder
    sd = Autoencoder(device="cpu").state_dict()
    assert convert_cli.verify("autoencoder", sd) == []
    bad = dict(sd)
    k0, k1 = list(bad)[:2]
    bad[k0] = torch.zeros(tuple(bad[k0].shape) + (2,))
    del bad[k1]
    bad["encoder.extra.weight"] = torch.zeros(3)
    probs = convert_cli.verify("autoencoder", bad)
    assert any(p.startswith("shape") and k0 in p for p in probs)
    assert any(p.startswith("missing") and k1 in p for p in probs)
    assert any(p.startswith("extra") and "encoder.extra" in p for p in probs)
    assert convert_cli.unwrap({"model": sd}) is sd
    assert convert_cli.unwrap({"state_dict": sd}) is sd


def test_convert_cli_verifies_a_checkpoint(tmp_path, capsys):
    from langscenex_tpu_torch.models.clip_dense import (CLIPTextConfig,
                                                        CLIPTextEncoder)
    sd = CLIPTextEncoder(CLIPTextConfig(), device="cpu").state_dict()
    ok = tmp_path / "clip_text.pt"
    torch.save({"state_dict": sd}, ok)
    assert convert_cli.main(["--family", "clip_text", "--input", str(ok),
                             "--verify"]) == 0
    assert "clip_text OK" in capsys.readouterr().out
    assert convert_cli.main(["--family", "lpips", "--input", str(ok),
                             "--verify"]) == 1
    with pytest.raises(SystemExit):          # nothing to convert
        convert_cli.main(["--family", "lpips", "--input", str(ok)])


# values the port's full-size module holds beyond JAX's traced flax init
# (convert_cli's docstring): SAM1's mask-prompt branch, VGGT's DINOv2 mask
# token, LPIPS's input shift and scale buffers, the AE's six
# num_batches_tracked counters
EXTRA_VALUES = {"sam1": 4684, "vggt": 1024, "lpips": 6, "autoencoder": 6}


@pytest.mark.parametrize("family", jconvert.FAMILIES)
def test_family_totals_equal_jax(family):
    mine = convert_cli.expected_shapes(family)
    ref = jconvert.expected_shapes(family)
    n = sum(int(np.prod(s)) for s in mine.values())
    n_ref = sum(int(np.prod(s)) for s in ref.values())
    assert n == n_ref + EXTRA_VALUES.get(family, 0), (family, n, n_ref)


def test_quick_start_tiny_chain(tmp_path):
    first, last = tmp_path / "first.png", tmp_path / "last.png"
    for p, seed in ((first, 1), (last, 2)):
        img = np.zeros((64, 96, 3), np.uint8)
        r = np.random.default_rng(seed)
        for _ in range(4):
            y, x = r.integers(8, 56), r.integers(8, 88)
            c = r.integers(50, 255, 3)
            img[max(y - 8, 0):y + 8, max(x - 10, 0):x + 10] = c
        write_png(str(p), img)
    dp = tmp_path / "demo"
    rec = quick_start.run(["--data_path", str(dp), "--first_image",
                           str(first), "--last_image", str(last), "--tiny",
                           "--iterations", "6", "--ae_epochs", "2",
                           "--pose_optim_iter", "2", "--render", "--eval"])
    assert set(rec["stage_t"]) == {"1_keyframes", "2_trimap_x3",
                                   "3_preprocess", "4_field", "5a_render",
                                   "5b_eval", "total"}
    assert rec["peak_gib"] == {}                 # no card

    # tests/test_quick_start_chain.py:41-77, the SURVEY §1 contract
    colors = np.load(dp / "seg" / "colors.npy")
    assert colors.ndim == 2 and colors.shape[1] == 3
    assert (colors[0] == 0).all()
    assert (dp / "seg" / "0001.png").exists()
    assert (dp / "normal" / "0001.png").exists()
    assert (dp / "colors.npy").exists()
    for kind in ("rgb", "seg", "normal"):
        frames = [f for f in os.listdir(dp / f"trimap_{kind}")
                  if f.endswith(".png")]
        assert len(frames) == 9, kind
    assert len(os.listdir(dp / "input")) == 9
    segs = [f for f in os.listdir(dp / "lang_features_dim3")
            if f.endswith("_s.npy")]
    feats = [f for f in os.listdir(dp / "lang_features_dim3")
             if f.endswith("_f.npy")]
    assert len(segs) == 9 and len(feats) == 9
    assert len(os.listdir(dp / "camera")) == 9
    assert (dp / "points3D.ply").exists()
    assert len(os.listdir(dp / "lang_features")) == 9
    out = dp / "output"
    assert (out / "point_cloud" / "iteration_6" / "point_cloud.ply").exists()
    pose = np.load(out / "pose" / "iter_6" / "pose_optimized.npy")
    assert pose.shape == (9, 4, 4)
    assert (out / "pose" / "iter_6" / "pose_org.npy").exists()
    assert len(os.listdir(dp / "render_camera")) == 9
    renders = os.listdir(out / "renders" / "iteration_6")
    assert any(f.endswith("_render.png") for f in renders)
    for d in ("renders_rgb", "renders_lang_npy", "renders_instance_npy"):
        assert len(os.listdir(out / "eval" / d)) == 9, d


def test_quick_start_tiny_refuses_a_card(tmp_path):
    with pytest.raises(ValueError, match="CPU only"):
        quick_start.run(["--data_path", str(tmp_path), "--tiny",
                         "--device", "cuda:0", "--skip_keyframes",
                         "--skip_trimap", "--skip_train"])
