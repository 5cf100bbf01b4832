"""The PyTorch port's step-function toolkit, pose evaluation, camera paths
and profiling utilities vs the JAX package's (CPU, float32): every public
``stepfun`` function on the same seeded inputs (``sample``'s jittered path
by its invariants, since a torch generator does not reproduce a PRNG key),
``pose_eval`` exactly (the same numpy code), the four camera paths and
``gen_virtual_cam`` from the same numpy generator state, and
``device_trace``'s trace file with a span in it. About 5
worker-seconds."""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_threads import few_torch_threads  # noqa: F401

from langscenex_tpu.utils import camera_paths as jpaths
from langscenex_tpu.utils import pose_eval as jpose
from langscenex_tpu.utils import stepfun as jsf
from langscenex_tpu_torch.utils import camera_paths as tpaths
from langscenex_tpu_torch.utils import pose_eval as tpose
from langscenex_tpu_torch.utils import profiling
from langscenex_tpu_torch.utils import stepfun as tsf

# f32 on both sides; the same formulas, so agreement is at f32 rounding
# (the linspaces and cumsums may round in another order)
ATOL, RTOL = 2e-6, 2e-5


def _step(rng, batch=(3,), n=7):
    t = np.sort(rng.uniform(-1, 2, batch + (n + 1,)), -1).astype(np.float32)
    w = rng.uniform(0, 1, batch + (n,)).astype(np.float32)
    return t, w / w.sum(-1, keepdims=True)


def _close(got, ref, atol=ATOL, rtol=RTOL):
    if isinstance(ref, (tuple, list)):
        assert len(got) == len(ref)
        for g, r in zip(got, ref):
            _close(g, r, atol, rtol)
        return
    g = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(g, np.asarray(ref), atol=atol, rtol=rtol)


def _both(fn_name, *args, **kw):
    """fn(*args) on the JAX and the port's stepfun, numpy inputs."""
    j = getattr(jsf, fn_name)(*(jnp.asarray(a) if isinstance(a, np.ndarray)
                                else a for a in args), **kw)
    t = getattr(tsf, fn_name)(*(torch.from_numpy(a) if isinstance(
        a, np.ndarray) else a for a in args), **kw)
    return t, j


def test_stepfun_lookup_functions_match_jax():
    rng = np.random.default_rng(0)
    t, w = _step(rng)
    q = rng.uniform(-1.5, 2.5, (3, 11)).astype(np.float32)
    q[:, 0] = t[:, 2]                          # queries on a fencepost
    lo_t, hi_t = tsf.searchsorted(torch.from_numpy(t), torch.from_numpy(q))
    lo_j, hi_j = jsf.searchsorted(jnp.asarray(t), jnp.asarray(q))
    np.testing.assert_array_equal(lo_t.numpy(), np.asarray(lo_j))
    np.testing.assert_array_equal(hi_t.numpy(), np.asarray(hi_j))
    _close(*_both("sorted_interp", q, t, rng.normal(size=t.shape)
                  .astype(np.float32)))
    _close(*_both("query", q, t, w, outside_value=-9.0))
    t1, w1 = _step(rng, n=5)
    _close(*_both("inner_outer", t, t1, w1))
    _close(*_both("lossfun_outer", t, w, t1, w1))
    _close(*_both("weight_to_pdf", t, w))
    _close(*_both("pdf_to_weight", t, w))
    _close(*_both("integrate_weights", w))
    u = np.sort(rng.uniform(0, 1, (3, 9)), -1).astype(np.float32)
    logits = rng.normal(size=w.shape).astype(np.float32)
    _close(*_both("invert_cdf", u, t, logits))
    _close(*_both("weighted_percentile", t, w, [10.0, 50.0, 90.0]))
    t2 = np.sort(rng.uniform(-1, 2, (3, 6)), -1).astype(np.float32)
    _close(*_both("resample", t2, t, w))
    _close(*_both("resample", t2, t, w, use_avg=True))
    # back-compat aliases
    t1d = np.sort(rng.uniform(0, 1, 9)).astype(np.float32)
    v = rng.uniform(-0.1, 1.1, 13).astype(np.float32)
    for a, b in zip(*_both("searchsorted_pair", t1d, v)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    _close(*_both("weights_to_cdf", w))


@pytest.mark.parametrize("renorm", [False, True])
def test_stepfun_dilation_and_losses_match_jax(renorm):
    rng = np.random.default_rng(1)
    t, w = _step(rng)
    _close(*_both("max_dilate", t, w, 0.3, domain=(-0.5, 1.5)))
    _close(*_both("max_dilate_weights", t, w, 0.3, domain=(-0.5, 1.5),
                  renormalize=renorm))
    _close(*_both("lossfun_distortion", t, w))
    for args in ((0.0, 1.0, 0.5, 2.5), (0.0, 1.0, 2.0, 3.0),
                 (np.float32(-1.0), np.float32(0.25), np.float32(-0.5),
                  np.float32(0.0))):
        _close(tsf.interval_distortion(*args),
               jsf.interval_distortion(*args))
    x = np.sort(rng.uniform(0, 3, (2, 8)), -1).astype(np.float32)
    y = rng.uniform(0, 1, (2, 7)).astype(np.float32)
    _close(*_both("blur_stepfun", x, y, 0.25))


@pytest.mark.parametrize("center", [False, True])
def test_stepfun_sample_deterministic_matches_jax(center):
    rng = np.random.default_rng(2)
    t, w = _step(rng, n=12)
    logits = np.log(w).astype(np.float32)
    _close(*_both("sample", None, t, logits, 16,
                  deterministic_center=center))
    _close(*_both("sample_intervals", None, t, logits, 16,
                  domain=(-0.5, 1.5)))


@pytest.mark.parametrize("single", [False, True])
def test_stepfun_sample_jittered_invariants(single):
    # the jittered path draws from a torch.Generator: its samples are
    # sorted, inside the bins, one stratum per sample, and a second
    # generator of the same seed gives the same samples
    rng = np.random.default_rng(3)
    t, w = _step(rng, n=12)
    tt, logits = torch.from_numpy(t), torch.log(torch.from_numpy(w))
    n = 32
    s = tsf.sample(torch.Generator().manual_seed(0), tt, logits, n,
                   single_jitter=single)
    s2 = tsf.sample(torch.Generator().manual_seed(0), tt, logits, n,
                    single_jitter=single)
    assert s.shape == (3, n)
    torch.testing.assert_close(s, s2, rtol=0, atol=0)
    assert (torch.diff(s, dim=-1) >= 0).all()
    assert (s >= tt[:, :1]).all() and (s <= tt[:, -1:]).all()
    # each sample's CDF value lies in its own stratum [i/n, (i+1)/n)
    cw = tsf.integrate_weights(torch.softmax(logits, -1))
    u = tsf.sorted_interp(s, tt, cw)
    i = torch.arange(n, dtype=torch.float32)
    assert (u >= i / n - 1e-5).all() and (u <= (i + 1) / n + 1e-5).all()
    if single:
        # one jitter per row: equal strides in u
        d = torch.diff(u, dim=-1)
        assert float((d - d.mean(-1, keepdim=True)).abs().max()) < 1e-4
    with pytest.raises(ValueError):
        tsf.sample_intervals(None, tt, logits, 1)


def test_pose_eval_equals_jax():
    rng = np.random.default_rng(4)
    gt = rng.normal(size=(12, 3))
    th = 0.4
    R = np.array([[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0],
                  [0, 0, 1]])
    est = 1.7 * gt @ R.T + np.array([0.3, -1.0, 2.0]) \
        + 0.01 * rng.normal(size=gt.shape)
    for a, b in zip(tpose.umeyama(est, gt), jpose.umeyama(est, gt)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tpose.align_trajectory(est, gt),
                                  jpose.align_trajectory(est, gt))
    for align in (True, False):
        assert tpose.ate_rmse(est, gt, align) == jpose.ate_rmse(est, gt,
                                                                align)
    poses = np.tile(np.eye(4), (6, 1, 1))
    poses[:, :3, 3] = rng.normal(size=(6, 3))
    noisy = poses.copy()
    noisy[:, :3, 3] += 0.05 * rng.normal(size=(6, 3))
    for d in (1, 2):
        assert tpose.rpe(noisy, poses, d) == jpose.rpe(noisy, poses, d)


def test_camera_paths_match_jax():
    rng = np.random.default_rng(5)
    centers = rng.normal(size=(9, 3)) + np.array([0.0, 0.0, -4.0])
    for kw in (dict(n_frames=20), dict(n_frames=12, z_rate=0.3),
               dict(n_frames=10, const_speed=False)):
        got, ref = tpaths.ellipse_path(centers, **kw), jpaths.ellipse_path(
            centers, **kw)
        assert got.shape == ref.shape == (kw["n_frames"], 4, 4)
        # theta is resampled in f32 on both sides
        np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(tpaths.spiral_path(centers, 16),
                                  jpaths.spiral_path(centers, 16))
    a = jpaths._look_at(np.array([0.0, 0.0, -3.0]), np.zeros(3),
                        np.array([0.0, -1.0, 0.0]))
    np.testing.assert_array_equal(
        tpaths._look_at(np.array([0.0, 0.0, -3.0]), np.zeros(3),
                        np.array([0.0, -1.0, 0.0])), a)
    b = jpaths._look_at(np.array([1.0, 0.5, -2.0]), np.zeros(3),
                        np.array([0.0, -1.0, 0.0]))
    np.testing.assert_array_equal(tpaths.interpolate_path(a, b, 7),
                                  jpaths.interpolate_path(a, b, 7))
    for seed in (0, 1):
        np.testing.assert_array_equal(
            tpaths.gen_virtual_cam(b, rng=np.random.default_rng(seed)),
            jpaths.gen_virtual_cam(b, rng=np.random.default_rng(seed)))


def test_device_trace_writes_a_trace(tmp_path):
    log_dir = tmp_path / "traces"
    with profiling.device_trace(str(log_dir)) as prof:
        with profiling.span("my_span"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    files = os.listdir(log_dir)
    assert len(files) == 1 and files[0].endswith(".json")
    assert prof.trace_path == str(log_dir / files[0])
    events = json.loads((log_dir / files[0]).read_text())["traceEvents"]
    assert any(e.get("name") == "my_span" for e in events)
    assert [r.name for r in profiling.records()] == ["my_span"]
