"""The field trainer's off-by-default options in the PyTorch port against
the JAX package (CPU): the per-point Adam (``pp_optimizer``, with its
CUT3R-confidence multipliers) and the normal prior (``normal_optim``:
the camera's normal map, the batch's prior and mask and the cosine loss
term with its gradients)."""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from PIL import Image
from test_torch_threads import few_torch_threads  # noqa: F401

from langscenex_tpu.ops.rasterize import RasterConfig as JConfig
from langscenex_tpu.scene.cameras import Camera as JCamera
from langscenex_tpu.scene.cameras import rgb_to_gray
from langscenex_tpu.scene.gaussians import GaussianState as JState
from langscenex_tpu.train import field as jfield
from langscenex_tpu.train import optim as jopt
from langscenex_tpu.train import per_point_adam as jpp
from langscenex_tpu.utils.config import OptimizationConfig as JCfg
from langscenex_tpu_torch import convert, pipeline
from langscenex_tpu_torch.ops.rasterize import RasterConfig
from langscenex_tpu_torch.scene.cameras import Camera
from langscenex_tpu_torch.train import field as tfield
from langscenex_tpu_torch.train import optim as topt
from langscenex_tpu_torch.train import per_point_adam as tpp
from langscenex_tpu_torch.utils.config import OptimizationConfig

W, H = 64, 32
CAP, N = 384, 320
SH = 1


def _t(a):
    return torch.from_numpy(np.array(a))


# ---- per-point Adam -----------------------------------------------------------

def test_confidence_lr_matches_jax():
    conf = np.random.default_rng(0).normal(0, 3, 50).astype(np.float32)
    np.testing.assert_allclose(
        tpp.confidence_lr(_t(conf)).numpy(),
        np.asarray(jpp.confidence_lr(jnp.asarray(conf))), rtol=1e-6)


def _pp_numpy(opt_state):
    """The JAX per-point Adam's state and the plain Adams' moments."""
    pp = [s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: isinstance(x, jpp.PerPointAdamState))
        if isinstance(s, jpp.PerPointAdamState)]
    adams = [s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)]
    mu, nu = {}, {}
    for a in adams:
        for k, v in a.mu.items():
            if not isinstance(v, optax.MaskedNode):
                mu[k], nu[k] = np.asarray(v), np.asarray(a.nu[k])
    p = pp[0]
    mu["xyz"] = np.asarray(jax.tree_util.tree_leaves(p.mu)[0])
    nu["xyz"] = np.asarray(jax.tree_util.tree_leaves(p.nu)[0])
    return dict(count=int(p.count), mu=mu, nu=nu,
                pplr=np.asarray(p.per_point_lr))


def test_per_point_adam_alone_matches_jax():
    # three steps of the one-group per-point Adam on a schedule
    rng = np.random.default_rng(1)
    x = rng.normal(size=(64, 3)).astype(np.float32)
    conf = np.asarray(jpp.confidence_lr(jnp.asarray(
        rng.normal(0, 2, 64).astype(np.float32))))
    sched = lambda c: topt.expon_lr(c, 1e-3, 1e-5, max_steps=10)  # noqa
    jtx = jpp.per_point_adam(lr=lambda c: jopt.expon_lr(c, 1e-3, 1e-5,
                                                        max_steps=10),
                             eps=1e-15, init_per_point_lr=jnp.asarray(conf))
    ttx = topt.GroupAdam(lr_fn=lambda c: {"xyz": sched(c)}, eps=1e-15,
                         per_point="xyz", init_per_point_lr=_t(conf))
    jp, tp = {"xyz": jnp.asarray(x)}, {"xyz": _t(x)}
    js, ts = jtx.init(jp), ttx.init(tp)
    for _ in range(3):
        g = rng.normal(size=(64, 3)).astype(np.float32)
        g[:5] = 0.0                                 # rows without gradient
        u, js = jtx.update({"xyz": jnp.asarray(g)}, js, jp)
        jp = optax.apply_updates(jp, u)
        tp, ts = ttx.update({"xyz": _t(g)}, ts, tp)
    # the same f32 formulas (test_torch_train's Adam bounds)
    np.testing.assert_allclose(tp["xyz"].numpy(), np.asarray(jp["xyz"]),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(ts.per_point_lr.numpy(),
                               np.asarray(js.per_point_lr), rtol=1e-6)
    np.testing.assert_allclose(ts.mu["xyz"].numpy(), np.asarray(js.mu["xyz"]),
                               rtol=1e-6, atol=1e-8)
    assert ts.count == int(js.count) == 3


def test_pp_splat_optimizer_matches_jax():
    # make_splat_optimizer(pp_optimizer=True): the xyz group on the
    # per-point Adam, the others plain; three steps with a densification
    # reset in between (zero_moments_at resets the multipliers to 1)
    rng = np.random.default_rng(2)
    cap = 64
    shapes = {"xyz": (cap, 3), "knn_f": (cap, 6), "features_dc": (cap, 1, 3),
              "features_rest": (cap, 15, 3), "scaling": (cap, 3),
              "rotation": (cap, 4), "opacity": (cap, 1),
              "language_feature": (cap, 3), "instance_feature": (cap, 3)}
    params = {k: rng.normal(size=s).astype(np.float32)
              for k, s in shapes.items()}
    conf = np.asarray(jpp.confidence_lr(jnp.asarray(
        rng.normal(0, 2, cap).astype(np.float32))))
    jtx = jopt.make_splat_optimizer(JCfg(pp_optimizer=True), 3.0,
                                    confidence_lr=jnp.asarray(conf))
    ttx = topt.make_splat_optimizer(OptimizationConfig(pp_optimizer=True),
                                    3.0, confidence_lr=_t(conf))
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: _t(v) for k, v in params.items()}
    js, ts = jtx.init(jp), ttx.init(tp)
    slots = rng.random(cap) < 0.2
    for i in range(3):
        g = {k: rng.normal(size=s).astype(np.float32)
             for k, s in shapes.items()}
        jg = jopt.phase_grad_mask("semantic", {k: jnp.asarray(v)
                                               for k, v in g.items()})
        u, js = jtx.update(jg, js, jp)
        jp = optax.apply_updates(jp, u)
        tp, ts = ttx.update(topt.phase_grad_mask(
            "semantic", {k: _t(v) for k, v in g.items()}), ts, tp)
        if i == 1:
            js = jopt.zero_moments_at(js, jnp.asarray(slots))
            ts = topt.zero_moments_at(ts, _t(slots))
    ja = _pp_numpy(js)
    assert ts.count == ja["count"] == 3
    np.testing.assert_allclose(ts.per_point_lr.numpy(), ja["pplr"],
                               rtol=1e-6)
    for k in params:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=1e-6, atol=1e-7, err_msg=k)
        np.testing.assert_allclose(ts.mu[k].numpy(), ja["mu"][k], rtol=1e-6,
                                   atol=1e-8, err_msg=k)
        np.testing.assert_allclose(ts.nu[k].numpy(), ja["nu"][k], rtol=1e-6,
                                   atol=1e-10, err_msg=k)


def test_pipeline_confidence_multipliers(tmp_path):
    # sparse/0/confidence_dsp.npy -> padded to the capacity -> multipliers;
    # without the file the per-point Adam is turned off, as the reference
    from langscenex_tpu_torch.utils.config import GaussianConfig
    cfg = GaussianConfig()
    cfg.opt.pp_optimizer = True
    pipe = pipeline.FieldConstructionPipeline(
        pipeline.PipelinePaths(data_path=str(tmp_path)), cfg, device="cpu")
    assert pipe._confidence_lr(8) is None and not cfg.opt.pp_optimizer
    os.makedirs(tmp_path / "sparse" / "0")
    conf = np.random.default_rng(3).normal(size=5).astype(np.float32)
    np.save(tmp_path / "sparse" / "0" / "confidence_dsp.npy", conf)
    cfg.opt.pp_optimizer = True
    got = pipe._confidence_lr(8)
    pad = np.zeros(8, np.float32)
    pad[:5] = conf
    np.testing.assert_allclose(got.numpy(), np.asarray(
        jpp.confidence_lr(jnp.asarray(pad), scale=(2.0, 100.0))), rtol=1e-6)
    assert cfg.opt.pp_optimizer


# ---- normal prior -------------------------------------------------------------

def _scene(tmp_path):
    """Two cameras with images in memory and normal maps on disk under
    <scene>/normal/ (the second camera's is missing), and random splats."""
    rng = np.random.default_rng(0)
    os.makedirs(tmp_path / "normal")
    jc, tc = [], []
    for i in range(2):
        img = rng.uniform(0, 1, (3, H, W)).astype(np.float32)
        if i == 0:
            n = rng.normal(size=(H, W, 3)) + [0, 0, -2.0]
            n /= np.linalg.norm(n, axis=-1, keepdims=True)
            n[:, :6] *= 1.5                              # masked out
            Image.fromarray(((n * 0.5 + 0.5).clip(0, 1) * 255).astype(
                np.uint8)).save(tmp_path / "normal" / f"v{i}.png")
        kw = dict(uid=i, colmap_id=i, R=np.eye(3),
                  T=np.array([0.04 * i, 0.0, 0.05 * i]), fovx=1.0, fovy=0.55,
                  width=W, height=H, image_name=f"v{i}",
                  image_path=str(tmp_path / "input" / f"v{i}.png"),
                  image=img, image_gray=rgb_to_gray(img), nearest_id=[1 - i])
        jc.append(JCamera(**kw))
        tc.append(Camera(**kw))
    d = dict(
        xyz=np.stack([rng.uniform(-1.2, 1.2, CAP), rng.uniform(-0.6, 0.6, CAP),
                      rng.uniform(2, 5, CAP)], -1),
        knn_f=rng.normal(size=(CAP, 6)),
        features_dc=rng.normal(0, 0.5, (CAP, 1, 3)),
        features_rest=rng.normal(0, 0.1, (CAP, 3, 3)),
        scaling=np.log(rng.uniform(0.02, 0.08, (CAP, 3))),
        rotation=rng.normal(size=(CAP, 4)),
        opacity=rng.normal(0, 1, (CAP, 1)),
        language_feature=rng.uniform(-1, 1, (CAP, 3)),
        instance_feature=rng.uniform(-1, 1, (CAP, 3)))
    d = {k: np.asarray(v, np.float32) for k, v in d.items()}
    d["alive"] = np.arange(CAP) < N
    return jc, tc, d


def _bad_rows(a, b, atol_frac, rtol):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = max(np.abs(a).max(), 1e-12)
    bad = np.abs(b - a) > atol_frac * scale + rtol * np.abs(a)
    return bad.reshape(bad.shape[0], -1).any(1).mean()


@pytest.mark.parametrize("pose", [False, True])
def test_normal_prior_loss_and_grads_match_jax(tmp_path, pose):
    # the single-view loss with normal_optim: the batch's prior and mask
    # equal JAX's, the loss within the train step's bound (rtol 2e-4) and
    # every gradient within its gradient bound (2e-3 of the largest + 5e-3
    # relative, all but 2% of rows)
    jc, tc, d = _scene(tmp_path)
    rc = dict(tile_w=32, tile_h=32, max_pairs=1 << 16)
    jtr = jfield.GaussianFieldTrainer(
        jc, JState(**{k: jnp.asarray(v) for k, v in d.items()}),
        JCfg(normal_optim=True), 4.0, sh_degree_max=SH,
        rcfg=JConfig(use_pallas=False, **rc))
    ttr = tfield.GaussianFieldTrainer(
        tc, convert.gaussian_state_from_numpy(d, "cpu"),
        OptimizationConfig(normal_optim=True), 4.0, sh_degree_max=SH,
        rcfg=RasterConfig(**rc))
    flags = jfield.StepFlags(image=False, single_view=True, multiview=False,
                             lang=False, instance=False, optim_pose=pose,
                             phase="semantic")
    tflags = tfield.StepFlags(*flags)
    jb, tb = jtr._camera_batch(0, flags), ttr._camera_batch(0, tflags)
    np.testing.assert_allclose(tb.normal_prior.numpy(),
                               np.asarray(jb.normal_prior), atol=1e-6)
    np.testing.assert_array_equal(tb.normal_mask.numpy(),
                                  np.asarray(jb.normal_mask))
    assert 0 < int(tb.normal_mask.sum()) < H * W
    # the camera without a normal map gets a zero prior and an empty mask
    assert not bool(ttr._camera_batch(1, tflags).normal_mask.any())

    s = jtr.state
    m2d0 = jnp.zeros((CAP, 2))

    def lf(params, poses):
        total, aux = jfield.view_loss(
            jtr.cfg, flags, jtr.rcfg, jtr.proxy_cam, SH, s.splats.alive,
            params, poses, s.app_ab, m2d0, jb, jax.random.PRNGKey(0), m2d0)
        return total, aux[0]
    (jt, jm), (gs, gp) = jax.value_and_grad(lf, argnums=(0, 1), has_aux=True)(
        jopt.splat_params(s.splats), s.poses)
    tt, tm, _, _, tg = tfield.loss_and_grads(
        ttr.cfg, tflags, ttr.rcfg, ttr.proxy_cam, ttr.state, tb,
        tfield.StepSamples(), SH)
    np.testing.assert_allclose(float(tt), float(jt), rtol=2e-4, atol=1e-6)
    np.testing.assert_allclose(float(tm["normal_loss"]),
                               float(jm["normal_loss"]), rtol=2e-4, atol=1e-6)
    for k in ("xyz", "scaling", "rotation", "opacity"):
        assert np.abs(np.asarray(gs[k])).max() > 0, k
        assert _bad_rows(np.asarray(gs[k]), tg[k].numpy(), 2e-3,
                         5e-3) <= 0.02, k
    if pose:
        assert _bad_rows(np.asarray(gp), tg["poses"].numpy(), 2e-3,
                         5e-3) == 0.0


def test_trainer_trains_with_both_options(tmp_path):
    # the former NotImplementedError paths: a few single-view iterations
    # with the normal prior and the per-point Adam, then densification's
    # reset of the multipliers
    _, tc, d = _scene(tmp_path)
    cfg = OptimizationConfig(normal_optim=True, pp_optimizer=True,
                             multi_view_weight_from_iter=10_000,
                             densify_from_iter=598,
                             densification_interval=600)
    conf = tpp.confidence_lr(torch.linspace(-3, 3, CAP))
    tr = tfield.GaussianFieldTrainer(tc, convert.gaussian_state_from_numpy(
        d, "cpu"), cfg, 4.0, sh_degree_max=SH,
        rcfg=RasterConfig(tile_w=32, tile_h=32), confidence_lr=conf)
    seen = []
    state, m = tr.train(iterations=601, first_iteration=599,
                        callback=lambda it, s, mm: seen.append(dict(mm)))
    assert all("normal_loss" in mm for mm in seen)
    assert all(bool(torch.isfinite(v)) for v in m.values())
    pplr = state.splat_opt.per_point_lr
    assert pplr.shape == (CAP, 1)
    assert not torch.allclose(pplr, conf)          # adjusted every step
    assert bool(torch.isfinite(state.splats.xyz).all())
    assert dataclasses.asdict(cfg)["pp_optimizer"]
