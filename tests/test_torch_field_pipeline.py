"""The field stage end to end in the PyTorch port against the JAX package
(CPU): the trainer's outputs (PLY and pose snapshots, the training report,
the debug collage, checkpoints and resume), FieldConstructionPipeline on
the scene of ``test_pipeline_e2e.py::TestConstructField``, the
``entry_point`` CLI (its override grammar, its errors and its default
device) and a run of the whole CLI in a process where PIL cannot be
imported."""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image
from test_torch_threads import few_torch_threads  # noqa: F401

from langscenex_tpu import entry_point as jentry
from langscenex_tpu import pipeline as jpipe
from langscenex_tpu.scene import ply_io as jply
from langscenex_tpu.scene.cameras import Camera as JCamera
from langscenex_tpu.scene.gaussians import create_from_points as jcreate
from langscenex_tpu.train import field as jfield
from langscenex_tpu.utils import config as jconfig
from langscenex_tpu_torch import entry_point, pipeline
from langscenex_tpu_torch.scene.cameras import Camera
from langscenex_tpu_torch.scene.gaussians import create_from_points
from langscenex_tpu_torch.train import checkpoint
from langscenex_tpu_torch.train import field as tfield
from langscenex_tpu_torch.utils import config as tconfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, H = 64, 48


def build_scene_dir(root, n=3):
    """test_pipeline_e2e.build_scene_dir: a CUT3R-contract scene (the same
    numpy draws, PNGs written by PIL)."""
    from langscenex_tpu.scene.dataset_readers import write_ply_points
    rng = np.random.default_rng(0)
    os.makedirs(os.path.join(root, "input"))
    os.makedirs(os.path.join(root, "camera"))
    pts = rng.uniform(-0.5, 0.5, (200, 3)).astype(np.float32)
    pts[:, 2] += 3.0
    cols = rng.uniform(0, 1, (200, 3)).astype(np.float32)
    write_ply_points(os.path.join(root, "points3D.ply"), pts, cols)
    for i in range(n):
        img = (rng.uniform(0, 1, (H, W, 3)) * 255).astype(np.uint8)
        Image.fromarray(img).save(os.path.join(root, "input",
                                               f"{i + 1:04d}.png"))
        pose = np.eye(4)
        pose[:3, 3] = [0.05 * i, 0, 0]
        K = np.array([[60.0, 0, W / 2], [0, 60.0, H / 2], [0, 0, 1]])
        np.savez(os.path.join(root, "camera", f"{i + 1:04d}.npz"), pose=pose,
                 intrinsics=K)


# TestConstructField's configuration, as CLI overrides and as configs
OPT = dict(iterations=6, max_geo_iter=100, single_view_weight_from_iter=10_000,
           multi_view_weight_from_iter=10_000, lang_loss_start_iter=10_000,
           densify_from_iter=10_000, optim_pose=False, loss_obj_3d=False,
           grouping_loss=False)
CLI = ([f"gaussian.opt.{k}={v}" for k, v in OPT.items()]
       + ["gaussian.dataset.sh_degree=1", "gaussian.render.load_iteration=6",
          "gaussian.render.pose_optim_iter=2",
          "pipeline.skip_video_process=true",
          "pipeline.skip_pose_estimate=true",
          "pipeline.skip_lang_feature_extraction=true"])


def _config(mod):
    cfg = mod.GaussianConfig(opt=mod.OptimizationConfig(**OPT),
                             dataset=mod.DatasetConfig(sh_degree=1))
    cfg.render.load_iteration = 6
    cfg.render.pose_optim_iter = 2
    return cfg


def _paths(mod, root):
    return mod.PipelinePaths(data_path=root, skip_video_process=True,
                             skip_pose_estimate=True,
                             skip_lang_feature_extraction=True)


def _tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def _record_losses(monkeypatch, cls, losses):
    train = cls.train

    def recorded(self, *args, **kw):
        kw["callback"] = lambda it, s, m: losses.append(float(m["total"]))
        return train(self, *args, **kw)
    monkeypatch.setattr(cls, "train", recorded)


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """TestConstructField through the JAX pipeline: per-iteration losses,
    the artifact tree and the eval results."""
    root = str(tmp_path_factory.mktemp("jax_scene"))
    build_scene_dir(root)
    losses = []
    with pytest.MonkeyPatch.context() as mp:
        _record_losses(mp, jfield.GaussianFieldTrainer, losses)
        pipe = jpipe.FieldConstructionPipeline(_paths(jpipe, root))
        pipe.cfg = _config(jconfig)
        pipe.construct_field(iterations=6)
    pipe.render_result(load_iteration=6)
    results = pipe.eval(load_iteration=6)
    return dict(root=root, losses=losses, results=results,
                tree=_tree(os.path.join(root, "output")))


def test_pipeline_matches_jax(jax_run, tmp_path, monkeypatch):
    # the port's FieldConstructionPipeline on the same scene: JAX's
    # per-iteration loss within the train step's bound (rtol 2e-4), the
    # same artifact tree and finite PSNRs
    root = str(tmp_path)
    build_scene_dir(root)
    losses = []
    _record_losses(monkeypatch, tfield.GaussianFieldTrainer, losses)
    pipe = pipeline.FieldConstructionPipeline(_paths(pipeline, root),
                                              device="cpu")
    pipe.cfg = _config(tconfig)
    state, metrics = pipe.construct_field(iterations=6)
    assert len(losses) == len(jax_run["losses"]) == 6
    np.testing.assert_allclose(losses, jax_run["losses"], rtol=2e-4,
                               atol=1e-6)
    stats = pipe.render_result(load_iteration=6)
    results = pipe.eval(load_iteration=6)
    assert len(results) == len(jax_run["results"]) == 3
    assert all(np.isfinite(r["psnr"]) for r in results)
    assert _tree(os.path.join(root, "output")) == jax_run["tree"]
    assert stats["mesh.ply"]["dims"] == (192, 192, 192)
    assert sorted(os.listdir(os.path.join(root, "render_camera"))) == [
        "0001.npz", "0002.npz", "0003.npz"]


def test_cli_runs_every_mode_without_pil(jax_run, tmp_path):
    # the CLI (main for train and render, run, main's body, for eval) with
    # device=cpu, in a process where `import PIL` fails: JAX's artifact
    # tree, finite PSNRs
    root = str(tmp_path)
    build_scene_dir(root)
    code = (
        "import sys, json\n"
        "sys.modules['PIL'] = None\n"
        "from langscenex_tpu_torch import entry_point\n"
        f"args = {CLI + ['device=cpu', f'pipeline.data_path={root}']!r}\n"
        "for mode in ('train', 'render'):\n"
        "    assert entry_point.main(['mode=' + mode] + args) == 0\n"
        "p = entry_point.run(['mode=eval'] + args)   # main's body\n"
        "print(json.dumps([r['psnr'] for r in p.result]))\n"
        "assert not any(k == 'PIL' or k.startswith('PIL.') for k, v in\n"
        "               sys.modules.items() if v is not None)\n")
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    psnr = [float(x) for x in proc.stdout.strip().splitlines()[-1]
            .strip("[]").split(",")]
    assert len(psnr) == 3 and all(np.isfinite(psnr))
    assert _tree(os.path.join(root, "output")) == jax_run["tree"]


# ---- the CLI's grammar and errors ---------------------------------------------

@pytest.mark.parametrize("overrides", [
    {"opt.iterations": "500", "dataset.white_background": "true",
     "opt.lambda_dssim": "0.3"},
    {"opt.iterations": "12_000", "opt.optim_pose": "no",
     "render.voxel_size": "0.02", "dataset.images": "frames",
     "start_checkpoint": "out/chkpnt7000"}])
def test_overrides_match_jax(overrides):
    j, t = jconfig.GaussianConfig(), tconfig.GaussianConfig()
    jentry.apply_overrides(j, dict(overrides))
    entry_point.apply_overrides(t, dict(overrides))
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    entry_point.apply_overrides(t, {"save_iterations": "10,30"})
    assert t.save_iterations == (10, 30)


@pytest.mark.parametrize("argv,match", [
    (["mode=bogus", "device=cpu"], "unknown mode"),
    (["device=cpu", "colour=red"], "unknown overrides"),
    (["device=cpu", "iterations"], "key=value")])
def test_cli_errors_match_jax(argv, match):
    with pytest.raises(SystemExit, match=match):
        entry_point.main(argv)
    with pytest.raises(SystemExit, match=match):
        jentry.main([a for a in argv if not a.startswith("device=")])


def test_cli_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry_point.main(["mode=render", f"pipeline.data_path={tmp_path}"])
    assert entry_point.main(["--help"]) == 0


# ---- trainer outputs ----------------------------------------------------------

def _trainers(tmp_path):
    """A JAX and a port trainer over the same three cameras (images read
    from PNGs) and the same initial splats, before their first step."""
    build_scene_dir(str(tmp_path))
    rng = np.random.default_rng(5)
    pts = np.stack([rng.uniform(-0.6, 0.6, 240), rng.uniform(-0.4, 0.4, 240),
                    rng.uniform(2.5, 3.5, 240)], -1).astype(np.float32)
    cols = rng.uniform(0, 1, (240, 3)).astype(np.float32)
    cams = []
    for mod in (JCamera, Camera):
        cams.append([mod(uid=i, colmap_id=3 - i, R=np.eye(3),
                         T=np.array([-0.05 * i, 0, 0]), fovx=1.0, fovy=0.8,
                         width=W, height=H, image_name=f"{i + 1:04d}",
                         image_path=str(tmp_path / "input" /
                                        f"{i + 1:04d}.png"))
                     for i in range(3)])
    cfg = dict(OPT, iterations=6)
    jtr = jfield.GaussianFieldTrainer(
        cams[0], jcreate(pts, cols, 1), jconfig.OptimizationConfig(**cfg),
        2.0, sh_degree_max=1)
    ttr = tfield.GaussianFieldTrainer(
        cams[1], create_from_points(pts, cols, 1, device="cpu"),
        tconfig.OptimizationConfig(**cfg), 2.0, sh_degree_max=1)
    return jtr, ttr


def test_trainer_outputs_match_jax(tmp_path):
    jtr, ttr = _trainers(tmp_path)
    jd, td = str(tmp_path / "j"), str(tmp_path / "t")
    # pose snapshots: nominal and optimised poses, ordered by colmap id
    jtr.save_pose_org(jd, (3,))
    ttr.save_pose_org(td, (3,))
    np.save(os.path.join(jd, "pose/iter_3/pose_optimized.npy"),
            jtr.poses_as_matrices())
    ttr.save_snapshot(td, 3)
    for f in ("pose_org.npy", "pose_optimized.npy"):
        np.testing.assert_allclose(np.load(os.path.join(td, "pose/iter_3", f)),
                                   np.load(os.path.join(jd, "pose/iter_3", f)),
                                   atol=1e-6, rtol=0, err_msg=f)
    # the PLY snapshot reads back through JAX's load_ply to the port's state
    js = jply.load_ply(os.path.join(td, "point_cloud/iteration_3/"
                                    "point_cloud.ply"), 1)
    alive = ttr.state.splats.alive.numpy()
    assert int(np.asarray(js.alive).sum()) == int(alive.sum())
    for f in dataclasses.fields(ttr.state.splats):
        if f.name in ("alive", "knn_f"):
            continue
        np.testing.assert_array_equal(
            np.asarray(getattr(js, f.name))[:int(alive.sum())],
            getattr(ttr.state.splats, f.name).numpy()[alive], err_msg=f.name)
    # the training report: JAX's numbers within 1e-4, its PNGs within 1 LSB
    jr = jtr.training_report(3, jd)
    tr = ttr.training_report(3, td)
    for k in ("l1", "psnr"):
        assert abs(tr[k] - jr[k]) <= 1e-4, (k, tr, jr)
    assert sorted(os.listdir(os.path.join(td, "valid"))) == sorted(
        os.listdir(os.path.join(jd, "valid")))
    for f in os.listdir(os.path.join(jd, "valid")):
        with Image.open(os.path.join(td, "valid", f)) as a, \
                Image.open(os.path.join(jd, "valid", f)) as b:
            assert np.abs(np.asarray(a).astype(int)
                          - np.asarray(b).astype(int)).max() <= 1
    # the debug collage: JAX's eight panels, as a PNG
    ttr.debug_collage(3, 1, td)
    with Image.open(os.path.join(td, "debug", "00003_0002.png")) as im:
        assert im.size == (4 * W, 2 * H) and im.mode == "RGB"


def test_checkpoint_round_trip_and_resume(tmp_path):
    # a checkpoint round-trips exactly under weights_only=True, and a run
    # resumed from iteration 3 continues to 6 as the uninterrupted run did,
    # with the pair caps it had at 3
    _, ttr = _trainers(tmp_path)
    _, full = _trainers(tmp_path / "b")
    full.train(iterations=6)
    ttr.rcfg = dataclasses.replace(ttr.rcfg, max_pairs=70_016)
    ttr.train(iterations=3, save_dir=str(tmp_path / "out"),
              checkpoint_iterations=(3,))
    assert checkpoint.latest_iteration(str(tmp_path / "out")) == 3
    saved = torch.load(tmp_path / "out" / "chkpnt3", weights_only=True)
    assert saved["trainer"]["max_pairs"] == 70_016
    _, resumed = _trainers(tmp_path / "c")
    assert resumed.restore(str(tmp_path / "out" / "chkpnt3")) == 3
    assert resumed.state.step == ttr.state.step == 3
    assert resumed.rcfg.max_pairs == 70_016
    for a, b in zip(_leaves(tfield.state_dict(resumed.state)),
                    _leaves(tfield.state_dict(ttr.state))):
        if torch.is_tensor(a):
            assert a.dtype == b.dtype
            torch.testing.assert_close(a, b, rtol=0, atol=0)
        else:
            assert a == b
    resumed.train(iterations=6, first_iteration=4)
    for a, b in zip(_leaves(tfield.state_dict(resumed.state)),
                    _leaves(tfield.state_dict(full.state))):
        if torch.is_tensor(a):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
        else:
            assert a == b
    with pytest.raises(FileNotFoundError):
        checkpoint.restore_checkpoint(str(tmp_path / "none"))


def _leaves(d):
    if isinstance(d, dict):
        for k in sorted(d):
            yield from _leaves(d[k])
    else:
        yield d
