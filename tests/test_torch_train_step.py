"""The field-construction train step of the PyTorch port vs the JAX
package's ``make_train_step`` (CPU, float32; the JAX blend through its
Pallas kernels in interpret mode). One state, warmed by one JAX step so
the Adam moments are non-zero, is carried into the port with
``convert.train_state_from_numpy``; then one step per phase flag set runs
on both sides from that state and batch, with JAX's PRNG draws injected
into the port. The loss, the metrics, the per-group gradients (read back
from the new first Adam moments: mu' = 0.9 mu + 0.1 g), the updated
parameters, poses, exposure table and densify statistics are compared."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_threads import few_torch_threads  # noqa: F401
from jax.experimental.pallas import tpu as pltpu

from langscenex_tpu.ops.rasterize import RasterConfig as JConfig
from langscenex_tpu.scene.cameras import Camera as JCamera
from langscenex_tpu.scene.cameras import rgb_to_gray
from langscenex_tpu.scene.gaussians import GaussianState as JState
from langscenex_tpu.train import field as jfield
from langscenex_tpu.utils.config import OptimizationConfig as JCfg
from langscenex_tpu_torch import convert
from langscenex_tpu_torch.ops.rasterize import RasterConfig
from langscenex_tpu_torch.scene.cameras import Camera
from langscenex_tpu_torch.train import field as tfield
from langscenex_tpu_torch.utils.config import OptimizationConfig

W, H = 64, 32            # 2x1 grid of 32x32 tiles
CAP, N = 384, 320
FOVX = 1.0
SH = 1
EXTENT = 4.0


def _adam_numpy(opt_state):
    adams = [s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)]
    if len(adams) == 1 and not isinstance(adams[0].mu, dict):
        a = adams[0]
        return dict(count=int(a.count), mu=np.asarray(a.mu),
                    nu=np.asarray(a.nu))
    mu, nu = {}, {}
    for a in adams:
        for k, v in a.mu.items():
            if not isinstance(v, optax.MaskedNode):
                mu[k], nu[k] = np.asarray(v), np.asarray(a.nu[k])
    return dict(count=int(adams[0].count), mu=mu, nu=nu)


def _state_numpy(s) -> dict:
    import dataclasses
    return dict(
        splats={f.name: np.asarray(getattr(s.splats, f.name))
                for f in dataclasses.fields(s.splats)},
        poses=np.asarray(s.poses), app_ab=np.asarray(s.app_ab),
        splat_opt=_adam_numpy(s.splat_opt), pose_opt=_adam_numpy(s.pose_opt),
        app_opt=_adam_numpy(s.app_opt),
        stats={f.name: np.asarray(getattr(s.stats, f.name))
               for f in dataclasses.fields(s.stats)},
        step=int(s.step))


def _cameras(tmp):
    rng = np.random.default_rng(0)
    from langscenex_tpu.ops.transforms import focal2fov, fov2focal
    fovy = focal2fov(fov2focal(FOVX, W), H)
    jc, tc = [], []
    for i in range(2):
        T = np.array([0.04 * i, 0.0, 0.05 * i])
        img = rng.uniform(0, 1, (3, H, W)).astype(np.float32)
        np.save(os.path.join(tmp, f"v{i}_f.npy"),
                rng.uniform(-1, 1, (3, H, W)).astype(np.float32))
        np.save(os.path.join(tmp, f"v{i}_s.npy"), rng.integers(-1, 5, (H, W)))
        kw = dict(uid=i, colmap_id=i, R=np.eye(3), T=T, fovx=FOVX, fovy=fovy,
                  width=W, height=H, image_name=f"v{i}", image=img,
                  image_gray=rgb_to_gray(img), nearest_id=[1 - i])
        jc.append(JCamera(**kw))
        tc.append(Camera(**kw))
    return jc, tc


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


RCFG = dict(tile_w=32, tile_h=32, max_pairs=1 << 16)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("lang"))
    jcams, tcams = _cameras(tmp)
    cfg = JCfg(multi_view_sample_num=600)
    jtr = jfield.GaussianFieldTrainer(
        jcams, JState(**{k: jnp.asarray(v) for k, v in _splats().items()}),
        cfg, EXTENT, sh_degree_max=3,
        rcfg=JConfig(use_pallas=True, **RCFG), lang_dir=tmp)
    # one JAX step (image + pose phase) so every Adam moment is non-zero
    flags0 = jfield.phase_flags(100, cfg)
    step0 = jfield.make_train_step(cfg, flags0, jtr.rcfg, jtr.proxy_cam,
                                   EXTENT)
    with pltpu.force_tpu_interpret_mode():
        state, _ = step0(jtr.state, jtr._camera_batch(1, flags0),
                         jax.random.PRNGKey(3), sh_degree=SH)
    ttr = tfield.GaussianFieldTrainer(
        tcams, convert.gaussian_state_from_numpy(_splats(), "cpu"),
        OptimizationConfig(multi_view_sample_num=600), EXTENT,
        rcfg=RasterConfig(**RCFG), lang_dir=tmp)
    return cfg, jtr, ttr, _state_numpy(state), state


def _samples(key, flags, cfg):
    def perm(k, n, m):
        return torch.from_numpy(np.asarray(
            jax.random.permutation(k, n)[:min(m, n)]))
    mv = perm(key, H * W, cfg.multi_view_sample_num) if flags.multiview \
        else None
    grp = obj = None
    if flags.lang:
        grp = perm(jax.random.fold_in(key, 3), H * W, 10_000)
        obj = perm(jax.random.fold_in(key, 7), CAP, 800)
    if flags.instance:
        grp = perm(jax.random.fold_in(key, 5), H * W, 1_000)
        obj = perm(jax.random.fold_in(key, 9), CAP, 800)
    return tfield.StepSamples(mv_sel=mv, group_idx=grp, obj_idx=obj)


def _bad_rows(a, b, atol_frac, rtol):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = max(np.abs(a).max(), 1e-12)
    bad = np.abs(b - a) > atol_frac * scale + rtol * np.abs(a)
    return bad.reshape(bad.shape[0], -1).any(1).mean()


# one iteration per phase flag set: image + pose; + single- and multi-view;
# the language phase (grouping + obj3d, every geometry loss still on); the
# semantic-only phase; the instance phase
PHASE_ITERS = {"geometry_pose": 100, "single_multi": 600, "language": 1300,
               "semantic_only": 1999, "instance": 12001}


@pytest.mark.parametrize("phase", list(PHASE_ITERS))
def test_train_step_matches_jax(setup, phase):
    cfg, jtr, ttr, s0_np, s0 = setup
    flags = jfield.phase_flags(PHASE_ITERS[phase], cfg)
    tflags = tfield.phase_flags(PHASE_ITERS[phase], ttr.cfg)
    assert tuple(tflags) == tuple(flags)
    key = jax.random.PRNGKey(11)
    jstep = jfield.make_train_step(cfg, flags, jtr.rcfg, jtr.proxy_cam,
                                   EXTENT)
    s_in = jax.tree_util.tree_map(jnp.copy, s0)    # the step donates it
    with pltpu.force_tpu_interpret_mode():
        js, jm = jstep(s_in, jtr._camera_batch(0, flags), key, sh_degree=SH)
    ts0 = convert.train_state_from_numpy(s0_np, "cpu")
    tstep = tfield.make_train_step(ttr.cfg, tflags, ttr.rcfg, ttr.proxy_cam,
                                   EXTENT)
    ts, tm = tstep(ts0, ttr._camera_batch(0, tflags),
                   _samples(key, flags, cfg), SH)
    j1 = _state_numpy(js)

    # loss and metrics: the blend differs from the Pallas kernel by its
    # rounding (see test_torch_blend_backward), the losses are f32 sums in
    # another order; counters are exact
    assert set(tm) == set(jm)
    for k in jm:
        if k in ("num_pairs", "num_big", "pair_overflow", "k_overflow"):
            assert float(tm[k]) == float(jm[k]), k
        else:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=2e-4, atol=1e-6, err_msg=k)
    assert int(jm["num_pairs"]) > 200

    # per-group gradients: g = (mu' - 0.9 mu) / 0.1 on each side, held to
    # the blend-gradient bounds of test_torch_grads (2e-3 of the largest
    # magnitude + 5e-3 relative, all but 2% of splats)
    for name, old, new_t, new_j in (
            [(k, s0_np["splat_opt"]["mu"][k], ts.splat_opt.mu[k].numpy(),
              j1["splat_opt"]["mu"][k]) for k in s0_np["splat_opt"]["mu"]]
            + [("poses", s0_np["pose_opt"]["mu"], ts.pose_opt.mu["poses"]
                .numpy(), j1["pose_opt"]["mu"]),
               ("app_ab", s0_np["app_opt"]["mu"], ts.app_opt.mu["app_ab"]
                .numpy(), j1["app_opt"]["mu"])]):
        gj = (new_j.astype(np.float64) - 0.9 * old) / 0.1
        gt = (new_t.astype(np.float64) - 0.9 * old) / 0.1
        assert _bad_rows(gj, gt, 2e-3, 5e-3) <= 0.02, name
    assert ts.splat_opt.count == j1["splat_opt"]["count"]
    assert ts.pose_opt.count == j1["pose_opt"]["count"]
    assert ts.app_opt.count == j1["app_opt"]["count"]

    # updated parameters: the Adam step scales each gradient by its own
    # moments, so a gradient rounding difference moves the parameter by a
    # fraction of the step: 1e-2 of the largest step + 1e-5 relative
    for k, v in j1["splats"].items():
        if k == "alive":
            np.testing.assert_array_equal(ts.splats.alive.numpy(), v)
            continue
        step_j = np.abs(v - s0_np["splats"][k]).max()
        np.testing.assert_allclose(getattr(ts.splats, k).numpy(), v,
                                   atol=1e-2 * step_j + 1e-7, rtol=1e-5,
                                   err_msg=k)
    for k in ("poses", "app_ab"):
        step_j = np.abs(j1[k] - s0_np[k]).max()
        np.testing.assert_allclose(getattr(ts, k).numpy(), j1[k],
                                   atol=1e-2 * step_j + 1e-7, rtol=1e-5,
                                   err_msg=k)
    # densify statistics (tracked before densify_until_iter): the abs
    # channel is the blend backward's exact hook on both sides
    for k, v in j1["stats"].items():
        got = getattr(ts.stats, k).numpy()
        if k in ("denom", "denom_abs", "max_radii2D"):
            np.testing.assert_array_equal(got, v, err_msg=k)
        else:
            assert _bad_rows(v, got, 2e-3, 5e-3) <= 0.02, k
    assert ts.step == j1["step"]
