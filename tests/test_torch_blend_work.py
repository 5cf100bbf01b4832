"""The blend kernels' work count, bound and forward check, on the CPU.

``rasterize_cuda.blend_work`` counts the (pair, pixel) evaluations of the
blend's per-pixel step on given inputs (walked, live, gated, included);
``chip_smoke.blend_bound`` turns those counts into K1's and K2's bounds.
Here the counts are held against a brute-force walk of every pixel in
float64, the bound against its terms written out by hand, and
``chip_smoke.check_blend``'s allowance for pixels rounded across the
1e-4 stop against outputs built to fall inside and outside it."""
import math
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from langscenex_tpu_torch.ops.binning import TileLists
from langscenex_tpu_torch.ops.rasterize_cuda import (ALPHA_MAX, ALPHA_MIN,
                                                     T_EPS, blend_work)
from test_torch_threads import few_torch_threads  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent


def _scene(rng, tile, grid, n, opacity):
    """Random splats over a grid of tiles and each tile's list of ``n``
    of them in a random depth order (the last tile's list empty)."""
    (tw, th), (gx, gy) = tile, grid
    P = 3 * n
    mean = np.stack([rng.uniform(-3, gx * tw + 3, P),
                     rng.uniform(-3, gy * th + 3, P)], -1)
    sig = rng.uniform(0.8, 5.0, (P, 2))
    ang = rng.uniform(0, np.pi, P)
    c, s = np.cos(ang), np.sin(ang)
    rot = np.stack([np.stack([c, -s], -1), np.stack([s, c], -1)], -2)
    inv = np.linalg.inv(rot @ (sig[:, :, None] ** 2
                               * np.swapaxes(rot, 1, 2)))
    conic = np.stack([inv[:, 0, 0], inv[:, 0, 1], inv[:, 1, 1]], -1)
    op = rng.uniform(*opacity, P)
    lists = [rng.permutation(P)[:n] for _ in range(gx * gy - 1)] + [[]]
    return mean, conic, op, lists


def _brute_force(mean, conic, op, lists, tile, grid):
    (tw, th), (gx, _) = tile, grid
    n = dict(walked=0, live=0, gated=0, included=0)
    for t, ids in enumerate(lists):
        x0, y0 = (t % gx) * tw, (t // gx) * th
        for py in range(y0, y0 + th):
            for px in range(x0, x0 + tw):
                T = 1.0
                for j in ids:
                    n["walked"] += 1
                    dx, dy = mean[j, 0] - px, mean[j, 1] - py
                    a, b, c = conic[j]
                    power = -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy
                    if power > 0:
                        continue
                    n["live"] += 1
                    alpha = min(ALPHA_MAX, op[j] * math.exp(power))
                    if alpha < ALPHA_MIN:
                        continue
                    n["gated"] += 1
                    if T * (1.0 - alpha) < T_EPS:
                        break
                    n["included"] += 1
                    T *= 1.0 - alpha
    return n


@pytest.mark.parametrize("tile,chunk,opacity,n", [
    ((8, 4), 4, (0.6, 0.95), 60),   # stops inside and across chunks
    ((4, 4), 64, (0.05, 0.3), 24),  # no stop, one chunk
    ((6, 2), 3, (0.9, 1.0), 60)])   # opacity up to 1: alpha clamped
def test_blend_work_matches_brute_force(tile, chunk, opacity, n):
    rng = np.random.default_rng(chunk)
    grid = (3, 2)
    mean, conic, op, lists = _scene(rng, tile, grid, n, opacity)
    counts = np.array([len(x) for x in lists], np.int32)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int32)
    zero = torch.zeros((), dtype=torch.int32)
    tl = TileLists(torch.from_numpy(np.concatenate(lists).astype(np.int32)),
                   torch.from_numpy(starts), torch.from_numpy(counts), zero,
                   zero.bool(), zero.bool(), zero)
    f = lambda a: torch.from_numpy(a.astype(np.float32))  # noqa: E731
    got = blend_work(tl, f(mean), f(conic), f(op), *grid, *tile, chunk)
    # the reference in float64 on the float32 inputs
    ref = _brute_force(*(a.astype(np.float32).astype(np.float64)
                         for a in (mean, conic, op)), lists, tile, grid)
    assert got == ref
    stops = ref["gated"] - ref["included"]
    assert (stops > 0) == (opacity[0] > 0.5)
    assert ref["included"] <= ref["gated"] <= ref["live"] <= ref["walked"]


def test_blend_bound_takes_the_largest_term(monkeypatch):
    monkeypatch.syspath_prepend(str(ROOT))
    import chip_smoke
    monkeypatch.setattr(chip_smoke, "sm_clock_mhz", lambda: 1000.0)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: types.SimpleNamespace(
                            multi_processor_count=100))
    work = dict(walked=1_000_000, live=900_000, gated=500_000,
                included=400_000)
    C = 8
    k1_fp32 = 12e6 + 2 * 900_000 + 2 * 500_000 + 17 * 400_000
    # K2's products over pixels count only the included evaluations
    k2_fp32 = k1_fp32 + 26 * 400_000 + 2 * 400_000 * 16
    sfu = 900_000 + 500_000 + 400_000
    sfu_ms = sfu / (16 * 100) / 1e6
    for backward, fp32 in ((False, k1_fp32), (True, k2_fp32)):
        b = chip_smoke.blend_bound(work, C, 1000, backward, "dev")
        assert b["fp32"] == fp32 and b["sfu"] == sfu
        assert b["terms"]["FP32"] == pytest.approx(fp32 / 67e12 * 1e3)
        assert b["terms"]["SFU"] == pytest.approx(sfu_ms)
        assert b["terms"]["bytes"] == pytest.approx(1000 / 3.35e12 * 1e3)
        assert b["bound_ms"] == max(b["terms"].values())
        assert b["bound_by"] == "operations"
        assert b["bound_term"] == max(b["terms"], key=b["terms"].get)
    b = chip_smoke.blend_bound(work, C, 10 ** 12, True, "dev")
    assert (b["bound_by"], b["bound_term"]) == ("bytes", "bytes")


def test_recorded_blend_backward_records_and_forwards(monkeypatch):
    monkeypatch.syspath_prepend(str(ROOT))
    import chip_smoke
    from langscenex_tpu_torch.ops import rasterize_cuda
    seen = []
    monkeypatch.setattr(rasterize_cuda, "_blend_backward_cuda",
                        lambda *a: seen.append(a) or "grad")
    x = torch.ones(2, requires_grad=True)
    with chip_smoke.recorded_blend_backward() as calls:
        assert rasterize_cuda._blend_backward_cuda(x, 3) == "grad"
    assert rasterize_cuda._blend_backward_cuda(x, 4) == "grad"
    assert len(calls) == 1 and len(seen) == 2
    assert not calls[0][0].requires_grad and calls[0][1] == 3


def _forward(rng, T):
    """(accum, T, observe) of 2 tiles x 3 channels x 64 pixels, and a
    copy of it as the plain reference."""
    accum = torch.from_numpy(rng.uniform(0, 1, (2, 3, 64)).astype(np.float32))
    T = torch.full((2, 64), T)
    obs = torch.zeros(40, dtype=torch.int32)
    return (accum, T, obs), (accum.clone(), T.clone(), obs.clone())


@pytest.mark.parametrize("T, moved, allowed, ok", [
    (0.5, 0, 0, True),          # equal outputs
    (1.0e-4, 1, 0, False),      # the render scene's check allows none
    (1.0e-4, 1, 4, True),       # a pixel rounded across the stop
    (1.0e-4, 4, 4, True),
    (1.0e-4, 5, 4, False),      # more than a few
    (0.05, 1, 4, False),        # T outside the stop's band: a defect
])
def test_check_blend_allows_a_few_pixels_at_the_stop(monkeypatch, T, moved,
                                                     allowed, ok):
    monkeypatch.syspath_prepend(str(ROOT))
    import chip_smoke
    got, ref = _forward(np.random.default_rng(0), T)
    got[0][1, 2, 7:7 + moved] += 0.01     # one channel of ``moved`` pixels
    if ok:
        err = chip_smoke.check_blend(got, ref, "case", allowed)
        assert err == pytest.approx(0.01 if moved else 0.0, abs=1e-6)
    else:
        with pytest.raises(AssertionError, match="accum differs"):
            chip_smoke.check_blend(got, ref, "case", allowed)
