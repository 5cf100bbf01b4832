"""Optimizer, densification, scene initialisation and the trainer loop of
the PyTorch port vs the JAX package (CPU, float32). Random draws that the
JAX code takes from PRNG keys (the densify noise) are drawn with
``jax.random`` and injected into the port."""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_threads import few_torch_threads  # noqa: F401

from langscenex_tpu.scene import gaussians as jg
from langscenex_tpu.train import densify as jdens
from langscenex_tpu.train import optim as jopt
from langscenex_tpu.utils.config import OptimizationConfig as JCfg
from langscenex_tpu_torch import convert
from langscenex_tpu_torch.ops.rasterize import RasterConfig
from langscenex_tpu_torch.ops.transforms import focal2fov, fov2focal
from langscenex_tpu_torch.scene import gaussians as tg
from langscenex_tpu_torch.scene.cameras import (Camera,
                                                compute_nearest_cameras)
from langscenex_tpu_torch.train import densify as tdens
from langscenex_tpu_torch.train import optim as topt
from langscenex_tpu_torch.train.field import (GaussianFieldTrainer,
                                              phase_flags)
from langscenex_tpu_torch.utils.config import OptimizationConfig


def _t(a):
    return torch.from_numpy(np.array(a))


def test_config_matches_jax():
    assert dataclasses.asdict(OptimizationConfig()) == \
        dataclasses.asdict(JCfg())


@pytest.mark.parametrize("kw", [
    dict(lr_init=1.6e-4 * 4, lr_final=1.6e-6 * 4, lr_delay_mult=0.01,
         max_steps=1000),
    dict(lr_init=1e-4, lr_final=1e-6, lr_delay_steps=50, lr_delay_mult=0.01,
         max_steps=12000),
    dict(lr_init=0.0, lr_final=0.0)])
def test_expon_lr_matches_jax(kw):
    for step in (0, 1, 7, 30, 499, 1000, 5000, 20000):
        np.testing.assert_allclose(topt.expon_lr(step, **kw),
                                   float(jopt.expon_lr(step, **kw)),
                                   rtol=1e-6, atol=1e-12)


def _params(rng, cap=64):
    return {"xyz": rng.normal(size=(cap, 3)), "knn_f": rng.normal(size=(cap, 6)),
            "features_dc": rng.normal(size=(cap, 1, 3)),
            "features_rest": rng.normal(size=(cap, 15, 3)),
            "scaling": rng.normal(size=(cap, 3)),
            "rotation": rng.normal(size=(cap, 4)),
            "opacity": rng.normal(size=(cap, 1)),
            "language_feature": rng.normal(size=(cap, 3)),
            "instance_feature": rng.normal(size=(cap, 3))}


def _f32(d):
    return {k: np.asarray(v, np.float32) for k, v in d.items()}


def _adam_numpy(opt_state):
    """(count, mu, nu) of every optax ScaleByAdamState in a state tree, as
    numpy per group (the ``convert.train_state_from_numpy`` layout)."""
    adams = [s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)]
    if len(adams) == 1 and not isinstance(adams[0].mu, dict):
        a = adams[0]
        return dict(count=int(a.count), mu=np.asarray(a.mu),
                    nu=np.asarray(a.nu))
    mu, nu, counts = {}, {}, set()
    for a in adams:
        counts.add(int(a.count))
        for k, v in a.mu.items():
            if not isinstance(v, optax.MaskedNode):
                mu[k], nu[k] = np.asarray(v), np.asarray(a.nu[k])
    assert len(counts) == 1
    return dict(count=counts.pop(), mu=mu, nu=nu)


@pytest.mark.parametrize("phase", ["semantic", "instance"])
def test_grouped_adam_matches_optax(phase):
    # three steps from non-zero moments with a phase mask: frozen groups
    # still move in optax (decayed moments), and must here too
    rng = np.random.default_rng(1)
    cfg = JCfg()
    params = _f32(_params(rng))
    jtx = jopt.make_splat_optimizer(cfg, 3.0)
    jstate = jtx.init({k: jnp.asarray(v) for k, v in params.items()})
    ttx = topt.make_splat_optimizer(OptimizationConfig(), 3.0)
    tstate = ttx.init({k: _t(v) for k, v in params.items()})
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: _t(v) for k, v in params.items()}
    for i in range(3):
        grads = _f32({k: rng.normal(size=v.shape) for k, v in params.items()})
        ph = "semantic" if i == 0 else phase
        jgm = jopt.phase_grad_mask(ph, {k: jnp.asarray(v)
                                        for k, v in grads.items()})
        upd, jstate = jtx.update(jgm, jstate, jp)
        jp = optax.apply_updates(jp, upd)
        tgm = topt.phase_grad_mask(ph, {k: _t(v) for k, v in grads.items()})
        tp, tstate = ttx.update(tgm, tstate, tp)
    ja = _adam_numpy(jstate)
    assert tstate.count == ja["count"] == 3
    # the same f32 formulas; schedules in f32 on both sides: a few ulp
    for k in params:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=1e-6, atol=1e-7, err_msg=k)
        np.testing.assert_allclose(tstate.mu[k].numpy(), ja["mu"][k],
                                   rtol=1e-6, atol=1e-8, err_msg=k)
        np.testing.assert_allclose(tstate.nu[k].numpy(), ja["nu"][k],
                                   rtol=1e-6, atol=1e-10, err_msg=k)


def test_pose_and_app_adam_match_optax():
    rng = np.random.default_rng(2)
    cfg = JCfg()
    for jtx, ttx, name, shape in (
            (jopt.make_pose_optimizer(cfg),
             topt.make_pose_optimizer(OptimizationConfig()), "poses", (5, 7)),
            (jopt.make_app_optimizer(), topt.make_app_optimizer(), "app_ab",
             (5, 2))):
        p = rng.normal(size=shape).astype(np.float32)
        jp, js = jnp.asarray(p), jtx.init(jnp.asarray(p))
        tp, ts = {name: _t(p)}, ttx.init({name: _t(p)})
        for _ in range(3):
            g = rng.normal(size=shape).astype(np.float32)
            u, js = jtx.update(jnp.asarray(g), js, jp)
            jp = optax.apply_updates(jp, u)
            tp, ts = ttx.update({name: _t(g)}, ts, tp)
        np.testing.assert_allclose(tp[name].numpy(), np.asarray(jp),
                                   rtol=1e-6, atol=1e-7, err_msg=name)


def test_masks_moments_and_stats_match_jax():
    rng = np.random.default_rng(3)
    cap = 64
    grads = _f32(_params(rng, cap))
    for phase in topt.PHASE_MASKS:
        a = jopt.phase_grad_mask(phase, {k: jnp.asarray(v)
                                         for k, v in grads.items()})
        b = topt.phase_grad_mask(phase, {k: _t(v) for k, v in grads.items()})
        for k in grads:
            np.testing.assert_array_equal(b[k].numpy(), np.asarray(a[k]))
    # zero_moments_at on a stepped state
    params = _f32(_params(rng, cap))
    jtx = jopt.make_splat_optimizer(JCfg(), 1.0)
    js = jtx.init({k: jnp.asarray(v) for k, v in params.items()})
    _, js = jtx.update({k: jnp.asarray(v) for k, v in grads.items()}, js,
                       {k: jnp.asarray(v) for k, v in params.items()})
    mask = rng.uniform(size=cap) < 0.3
    ja = _adam_numpy(jopt.zero_moments_at(js, jnp.asarray(mask)))
    ts = convert.train_state_from_numpy(dict(
        splats=dict(**params, alive=np.ones(cap, bool)),
        poses=np.zeros((1, 7)), app_ab=np.zeros((1, 2)),
        splat_opt=_adam_numpy(js),
        pose_opt=dict(count=0, mu=np.zeros((1, 7)), nu=np.zeros((1, 7))),
        app_opt=dict(count=0, mu=np.zeros((1, 2)), nu=np.zeros((1, 2))),
        stats={k: np.zeros(cap) for k in ("xyz_gradient_accum",
                                          "xyz_gradient_accum_abs", "denom",
                                          "denom_abs", "max_radii2D")},
        step=0), "cpu").splat_opt
    tz = topt.zero_moments_at(ts, _t(mask))
    for k in params:
        np.testing.assert_array_equal(tz.mu[k].numpy(), ja["mu"][k])
        np.testing.assert_array_equal(tz.nu[k].numpy(), ja["nu"][k])
    # DensifyStats.update
    g = rng.normal(size=(cap, 2)).astype(np.float32)
    ga = np.abs(g) + rng.uniform(size=(cap, 2)).astype(np.float32)
    radii = rng.uniform(0, 30, cap).astype(np.float32)
    filt = rng.uniform(size=cap) < 0.6
    js_ = jg.DensifyStats.zeros(cap)
    ts_ = tg.DensifyStats.zeros(cap, "cpu")
    for _ in range(2):
        js_ = js_.update(jnp.asarray(g), jnp.asarray(ga), jnp.asarray(radii),
                         jnp.asarray(filt))
        ts_ = ts_.update(_t(g), _t(ga), _t(radii), _t(filt))
    for f in dataclasses.fields(ts_):
        np.testing.assert_allclose(getattr(ts_, f.name).numpy(),
                                   np.asarray(getattr(js_, f.name)),
                                   rtol=1e-6, err_msg=f.name)


def _dense_state(rng, cap, n):
    d = _f32(_params(rng, cap))
    d["scaling"] = np.log(rng.uniform(0.001, 0.02, (cap, 3))).astype(
        np.float32)
    d["opacity"] = rng.normal(0, 2, (cap, 1)).astype(np.float32)
    alive = np.zeros(cap, bool)
    alive[:n] = True
    d["alive"] = alive
    stats = dict(xyz_gradient_accum=rng.uniform(0, 0.02, cap),
                 xyz_gradient_accum_abs=rng.uniform(0, 0.05, cap),
                 denom=rng.integers(0, 4, cap).astype(np.float64),
                 denom_abs=rng.integers(0, 4, cap).astype(np.float64),
                 max_radii2D=rng.uniform(0, 40, cap))
    return d, _f32(stats)


@pytest.mark.parametrize("case", ["roomy", "capped", "size_threshold"])
def test_densify_and_prune_matches_jax(case):
    rng = np.random.default_rng(4)
    cap, n = 512, {"roomy": 200, "capped": 480, "size_threshold": 300}[case]
    d, stats = _dense_state(rng, cap, n)
    kw = dict(max_abs_split_points=20) if case == "roomy" else {}
    jcfg, tcfg = JCfg(**kw), OptimizationConfig(**kw)
    size_th = 20 if case == "size_threshold" else None
    key = jax.random.PRNGKey(9)
    noise = np.asarray(jax.random.normal(key, (cap, 3)))
    jr = jdens.densify_and_prune(
        key, jg.GaussianState(**{k: jnp.asarray(v) for k, v in d.items()}),
        jg.DensifyStats(**{k: jnp.asarray(v) for k, v in stats.items()}),
        jcfg, 2.5, size_th)
    tr = tdens.densify_and_prune(
        _t(noise), convert.gaussian_state_from_numpy(d, "cpu"),
        tg.DensifyStats(**{k: _t(v) for k, v in stats.items()}), tcfg, 2.5,
        size_th)
    # selections and slot allocation: exact
    for f in ("n_cloned", "n_split", "n_pruned"):
        assert int(getattr(tr, f)) == int(getattr(jr, f)), f
    assert int(tr.n_cloned) + int(tr.n_split) > 5
    np.testing.assert_array_equal(tr.written_slots.numpy(),
                                  np.asarray(jr.written_slots))
    np.testing.assert_array_equal(tr.state.alive.numpy(),
                                  np.asarray(jr.state.alive))
    if case == "capped":        # every new copy needs a free slot
        assert int(tr.n_cloned) + int(tr.n_split) == cap - n
    for f in convert.GAUSSIAN_FIELDS[:-1]:
        np.testing.assert_allclose(getattr(tr.state, f).numpy(),
                                   np.asarray(getattr(jr.state, f)),
                                   rtol=1e-5, atol=1e-6, err_msg=f)
    assert float(tr.stats.denom.abs().sum()) == 0.0


def test_create_from_points_matches_jax():
    rng = np.random.default_rng(5)
    pts = rng.uniform(-1, 1, (700, 3)).astype(np.float32)
    cols = rng.uniform(0, 1, (700, 3)).astype(np.float32)
    a = jg.create_from_points(pts, cols, capacity=1024)
    b = tg.create_from_points(pts, cols, capacity=1024, device="cpu")
    for f in convert.GAUSSIAN_FIELDS:
        if f == "knn_f":
            continue        # drawn from each package's own generator
        np.testing.assert_allclose(getattr(b, f).numpy(),
                                   np.asarray(getattr(a, f)), rtol=1e-5,
                                   atol=1e-7, err_msg=f)
    assert b.knn_f.shape == (1024, 6)
    assert float(b.knn_f[700:].abs().sum()) == 0.0
    assert 0.8 < float(b.knn_f[:700].std()) < 1.2


def _trainer_cams(tmp_path, W=64, H=32, n=3):
    rng = np.random.default_rng(6)
    fovy = focal2fov(fov2focal(1.0, W), H)
    cams = []
    for i in range(n):
        c = Camera(uid=i, colmap_id=n - i, R=np.eye(3),
                   T=np.array([0.03 * i, 0.0, 0.05 * i]), fovx=1.0,
                   fovy=fovy, width=W, height=H, image_name=f"v{i}")
        c.image = rng.uniform(0, 1, (3, H, W)).astype(np.float32)
        np.save(os.path.join(tmp_path, f"v{i}_f.npy"),
                rng.uniform(-1, 1, (3, H // 2, W // 2)).astype(np.float32))
        np.save(os.path.join(tmp_path, f"v{i}_s.npy"),
                rng.integers(-1, 4, (H, W)))
        cams.append(c)
    compute_nearest_cameras(cams, max_dis=10.0)
    return cams


def test_trainer_runs_phase_windows_across_densification(tmp_path):
    cams = _trainer_cams(tmp_path)
    assert all(c.nearest_id for c in cams)
    rng = np.random.default_rng(7)
    pts = np.stack([rng.uniform(-1, 1, 300), rng.uniform(-0.5, 0.5, 300),
                    rng.uniform(2, 5, 300)], -1).astype(np.float32)
    splats = tg.create_from_points(pts, rng.uniform(0, 1, (300, 3)),
                                   capacity=512, device="cpu")
    cfg = OptimizationConfig(multi_view_sample_num=500)
    tr = GaussianFieldTrainer(cams, splats, cfg, scene_extent=4.0,
                              rcfg=RasterConfig(), lang_dir=str(tmp_path))
    assert tr.rcfg.max_pairs == 1 << 16
    seen = []
    for first, last in ((1, 3), (599, 601), (1299, 1300), (12000, 12001)):
        state, m = tr.train(iterations=last, first_iteration=first,
                            callback=lambda it, s, mm: seen.append(
                                (it, phase_flags(it, cfg), dict(mm))))
        assert all(bool(torch.isfinite(v)) for v in m.values())
        assert float(m["pair_overflow"]) == 0.0
    names = {it: set(mm) for it, _, mm in seen}
    assert "image_loss" in names[1] and "geo_loss" not in names[1]
    assert {"normal_loss", "geo_loss", "ncc_loss"} <= names[600]
    assert {"lang_loss", "grouping_loss", "obj3d_loss"} <= names[1300]
    assert {"ins_grouping_loss", "ins_obj3d_loss"} <= names[12001]
    # densification at 600 wrote slots and reset their moments
    assert int(state.splats.num_alive) > 300
    assert state.step == 10
    assert tr.active_sh_degree == 3
    # the instance phase began with a copy of the language features
    assert tr.poses_as_matrices().shape == (3, 4, 4)
    for p in (state.splats.xyz, state.poses, state.app_ab):
        assert bool(torch.isfinite(p).all())
    # the save_dir outputs are ported: a PLY and pose snapshot
    tr.train(iterations=2, save_dir=str(tmp_path), save_iterations=(2,))
    assert (tmp_path / "point_cloud" / "iteration_2" /
            "point_cloud.ply").exists()
    assert np.load(tmp_path / "pose" / "iter_2" /
                   "pose_optimized.npy").shape == (3, 4, 4)
