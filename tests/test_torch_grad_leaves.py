"""The field step differentiates only the leaves its update reads
(``train/field.trained_leaves``): in each phase the gradients of those
leaves, and the state one step later, are bit-equal to differentiating all
13 leaves and masking the result, as the step did before; every other leaf
gets exact zeros. The counters ``field.grad_leaves`` and
``field.grad_leaves_skipped`` count both kinds once a step, and a
replaced ``phase_grad_mask`` (the benchmark's planted fault
``frozen_moved``) is followed: every group it lets through is
differentiated again. CPU, float32, no JAX."""
import dataclasses
import os

import numpy as np
import pytest
import torch
from test_torch_threads import few_torch_threads  # noqa: F401

from langscenex_tpu_torch import convert
from langscenex_tpu_torch.ops import losses as L
from langscenex_tpu_torch.ops.rasterize import RasterConfig
from langscenex_tpu_torch.ops.transforms import focal2fov, fov2focal
from langscenex_tpu_torch.scene.cameras import Camera, rgb_to_gray
from langscenex_tpu_torch.train import field as tfield
from langscenex_tpu_torch.train.optim import PARAM_FIELDS, splat_params
from langscenex_tpu_torch.utils import profiling
from langscenex_tpu_torch.utils.config import OptimizationConfig

W, H = 64, 32            # 2x1 grid of 32x32 tiles
CAP, N = 384, 320
FOVX = 1.0
SH = 3
EXTENT = 4.0
LEAVES = PARAM_FIELDS + ("poses", "app_ab", "mean2d", "mean2d_abs")
# one iteration per phase flag set (tests/test_torch_train_step.py's):
# image + pose; + single- and multi-view; the language phase; the
# semantic-only phase; the instance phase
PHASE_ITERS = {"geometry_pose": 100, "single_multi": 600, "language": 1300,
               "semantic_only": 1999, "instance": 12001}
# the leaves each of those steps differentiates
TRAINED = {
    "geometry_pose": set(PARAM_FIELDS) - {"instance_feature"} | {
        "poses", "app_ab", "mean2d", "mean2d_abs"},
    "single_multi": set(PARAM_FIELDS) - {"instance_feature"} | {
        "poses", "app_ab", "mean2d", "mean2d_abs"},
    "language": set(PARAM_FIELDS) - {"instance_feature"} | {
        "poses", "app_ab"},
    "semantic_only": {"language_feature"},
    "instance": {"instance_feature"},
}


def _cameras(tmp):
    rng = np.random.default_rng(0)
    fovy = focal2fov(fov2focal(FOVX, W), H)
    cams = []
    for i in range(2):
        img = rng.uniform(0, 1, (3, H, W)).astype(np.float32)
        np.save(os.path.join(tmp, f"v{i}_f.npy"),
                rng.uniform(-1, 1, (3, H, W)).astype(np.float32))
        np.save(os.path.join(tmp, f"v{i}_s.npy"), rng.integers(-1, 5, (H, W)))
        cams.append(Camera(
            uid=i, colmap_id=i, R=np.eye(3),
            T=np.array([0.04 * i, 0.0, 0.05 * i]), fovx=FOVX, fovy=fovy,
            width=W, height=H, image_name=f"v{i}", image=img,
            image_gray=rgb_to_gray(img), nearest_id=[1 - i]))
    return cams


def _splats():
    rng = np.random.default_rng(1)
    d = dict(
        xyz=np.stack([rng.uniform(-1.2, 1.2, CAP), rng.uniform(-0.6, 0.6, CAP),
                      rng.uniform(2, 5, CAP)], -1),
        knn_f=rng.normal(size=(CAP, 6)),
        features_dc=rng.normal(0, 0.5, (CAP, 1, 3)),
        features_rest=rng.normal(0, 0.1, (CAP, 15, 3)),
        scaling=np.log(rng.uniform(0.02, 0.08, (CAP, 3))),
        rotation=rng.normal(size=(CAP, 4)),
        opacity=rng.normal(0, 1, (CAP, 1)),
        language_feature=rng.uniform(-1, 1, (CAP, 3)),
        instance_feature=rng.uniform(-1, 1, (CAP, 3)))
    d = {k: np.asarray(v, np.float32) for k, v in d.items()}
    d["alive"] = np.arange(CAP) < N
    return d


def full_loss_and_grads(cfg, flags, rcfg, proxy_cam, state, batch, samples,
                        sh_degree):
    """``loss_and_grads`` differentiating all 13 leaves, zeros where the
    loss does not reach one."""
    cap, dev = state.splats.capacity, state.splats.device
    with L.exact_f32():
        leaves = {k: v.detach().requires_grad_()
                  for k, v in splat_params(state.splats).items()}
        leaves["poses"] = state.poses.detach().requires_grad_()
        leaves["app_ab"] = state.app_ab.detach().requires_grad_()
        leaves["mean2d"] = torch.zeros((cap, 2), device=dev,
                                       requires_grad=True)
        leaves["mean2d_abs"] = torch.zeros((cap, 2), device=dev,
                                           requires_grad=True)
        params = {k: leaves[k] for k in PARAM_FIELDS}
        total, (metrics, radii, _, visible) = tfield.view_loss(
            cfg, flags, rcfg, proxy_cam, sh_degree, state.splats.alive,
            params, leaves["poses"], leaves["app_ab"], leaves["mean2d"],
            batch, samples, leaves["mean2d_abs"])
        gs = torch.autograd.grad(total, list(leaves.values()),
                                 allow_unused=True)
    grads = {k: torch.zeros_like(v) if g is None else g
             for (k, v), g in zip(leaves.items(), gs)}
    metrics = {k: v.detach() for k, v in metrics.items()}
    return total.detach(), metrics, radii, visible, grads


def _flat(d, prefix=""):
    for k, v in d.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def _assert_states_equal(a, b):
    fa, fb = dict(_flat(tfield.state_dict(a))), dict(_flat(
        tfield.state_dict(b)))
    assert fa.keys() == fb.keys()
    for k, v in fa.items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(v, fb[k]), k
        else:
            assert v == fb[k], k


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """A trainer on the seeded scene, and a state warmed by one full
    geometry step so that every Adam moment is non-zero."""
    tmp = str(tmp_path_factory.mktemp("lang"))
    tr = tfield.GaussianFieldTrainer(
        _cameras(tmp), convert.gaussian_state_from_numpy(_splats(), "cpu"),
        OptimizationConfig(multi_view_sample_num=600), EXTENT,
        sh_degree_max=SH, rcfg=RasterConfig(tile_w=32, tile_h=32,
                                            max_pairs=1 << 16),
        lang_dir=tmp)
    flags0 = tfield.phase_flags(100, tr.cfg)
    warm = tfield.make_train_step(tr.cfg, flags0, tr.rcfg, tr.proxy_cam,
                                  EXTENT)
    warmed, _ = warm(tr.state, tr._camera_batch(1, flags0),
                     tr.draw_samples(flags0), SH)
    return tr, warmed


def _at(tr, state, phase):
    """The phase's flags, batch and draws, and ``state`` at its step."""
    it = PHASE_ITERS[phase]
    flags = tfield.phase_flags(it, tr.cfg)
    return (flags, tr._camera_batch(0, flags), tr.draw_samples(flags),
            dataclasses.replace(state, step=it - 1))


@pytest.mark.parametrize("phase", list(PHASE_ITERS))
def test_step_matches_full_differentiation(scene, phase, monkeypatch):
    tr, warmed = scene
    flags, batch, samples, state = _at(tr, warmed, phase)
    args = (tr.cfg, flags, tr.rcfg, tr.proxy_cam, state, batch, samples, SH)
    assert tfield.trained_leaves(tr.cfg, flags, state.step) == \
        TRAINED[phase]
    before = dict(profiling.counters)
    total, metrics, radii, visible, grads = tfield.loss_and_grads(*args)
    counted = {k: profiling.counters.get(k, 0) - before.get(k, 0)
               for k in ("field.grad_leaves", "field.grad_leaves_skipped")}
    assert counted == {"field.grad_leaves": len(TRAINED[phase]),
                       "field.grad_leaves_skipped":
                       len(LEAVES) - len(TRAINED[phase])}
    ftotal, fmetrics, fradii, fvisible, fgrads = full_loss_and_grads(*args)
    assert torch.equal(total, ftotal)
    assert metrics.keys() == fmetrics.keys()
    assert all(torch.equal(metrics[k], fmetrics[k]) for k in metrics)
    assert torch.equal(radii, fradii) and torch.equal(visible, fvisible)
    assert set(grads) == set(LEAVES)
    for k in LEAVES:
        if k in TRAINED[phase]:
            assert torch.equal(grads[k], fgrads[k]), k
        else:
            assert not grads[k].any() and grads[k].shape == fgrads[k].shape, k
    assert grads[{"instance": "instance_feature",
                  "semantic_only": "language_feature",
                  "language": "language_feature"}.get(phase, "xyz")].any()

    step = tfield.make_train_step(tr.cfg, flags, tr.rcfg, tr.proxy_cam,
                                  EXTENT)
    new, _ = step(state, batch, samples, SH)
    monkeypatch.setattr(tfield, "loss_and_grads", full_loss_and_grads)
    ref, _ = step(state, batch, samples, SH)
    _assert_states_equal(new, ref)


def test_parallel_step_matches_full_differentiation(scene, monkeypatch):
    tr, warmed = scene
    flags = tfield.phase_flags(PHASE_ITERS["semantic_only"], tr.cfg)
    state = dataclasses.replace(warmed, step=PHASE_ITERS["semantic_only"] - 1)
    batches = [tr._camera_batch(i, flags) for i in range(2)]
    samples = [tr.draw_samples(flags) for _ in range(2)]
    step = tfield.make_parallel_train_step(tr.cfg, flags, tr.rcfg,
                                           tr.proxy_cam, EXTENT, mesh=None)
    before = dict(profiling.counters)
    new, metrics = step(state, batches, samples, SH)
    # once a step, over the parallel step's 12 leaves (no abs hook)
    assert profiling.counters["field.grad_leaves"] \
        - before.get("field.grad_leaves", 0) == 1
    assert profiling.counters["field.grad_leaves_skipped"] \
        - before.get("field.grad_leaves_skipped", 0) == 11
    monkeypatch.setattr(tfield, "trained_leaves",
                        lambda cfg, flags, step: set(LEAVES))
    ref, ref_metrics = step(state, batches, samples, SH)
    _assert_states_equal(new, ref)
    assert all(torch.equal(metrics[k], ref_metrics[k]) for k in metrics)


def test_a_replaced_mask_is_followed(scene, monkeypatch):
    # the benchmark's fault frozen_moved: a mask that lets every group
    # through. From a state with zero moments a frozen group moves only
    # if it receives a gradient.
    tr, _ = scene
    flags, batch, samples, state = _at(tr, tr.state, "semantic_only")
    step = tfield.make_train_step(tr.cfg, flags, tr.rcfg, tr.proxy_cam,
                                  EXTENT)
    kept, _ = step(state, batch, samples, SH)
    assert torch.equal(kept.splats.xyz, state.splats.xyz)
    monkeypatch.setattr(tfield, "phase_grad_mask",
                        lambda phase, grads: dict(grads))
    assert tfield.trained_leaves(tr.cfg, flags, state.step) == \
        set(PARAM_FIELDS)
    grads = tfield.loss_and_grads(tr.cfg, flags, tr.rcfg, tr.proxy_cam,
                                  state, batch, samples, SH)[4]
    assert grads["xyz"].any()
    moved, _ = step(state, batch, samples, SH)
    assert not torch.equal(moved.splats.xyz, state.splats.xyz)


@pytest.mark.parametrize("phase,counts", [("semantic_only", (1, 12)),
                                          ("language", (10, 3))])
def test_counters_count_a_step_once(scene, phase, counts):
    tr, warmed = scene
    flags, batch, samples, state = _at(tr, warmed, phase)
    step = tfield.make_train_step(tr.cfg, flags, tr.rcfg, tr.proxy_cam,
                                  EXTENT)
    before = dict(profiling.counters)
    step(state, batch, samples, SH)
    assert tuple(profiling.counters[k] - before.get(k, 0)
                 for k in ("field.grad_leaves",
                           "field.grad_leaves_skipped")) == counts
