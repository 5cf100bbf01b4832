"""PyTorch port of binning vs the JAX package: the same ProcessedSplats
(JAX's own preprocess output, carried across as numpy) go through both
``build_tile_lists``; lists, counters and flags must be bit-identical.
Feeding JAX's preprocess to both sides keeps ulp-level differences in
log/sqrt/exp from moving a cull or rect decision."""
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_threads import few_torch_threads  # noqa: F401

from langscenex_tpu.ops import transforms as jtf
from langscenex_tpu.ops.binning import CullSpec as JCull
from langscenex_tpu.ops.binning import build_tile_lists as jax_build
from langscenex_tpu.ops.projection import RasterCamera, preprocess
from langscenex_tpu_torch.ops.binning import CullSpec, build_tile_lists
from langscenex_tpu_torch.ops.projection import ProcessedSplats

FIELDS = ("point_list", "tile_starts", "tile_counts", "num_pairs",
          "overflowed", "k_overflowed", "num_big")


@functools.partial(jax.jit, static_argnums=(5, 6, 7))
def _jax_prep(means, scales, quats, opac, proj, W, H, tile):
    """JAX preprocess + cull spec, jitted (eager op-by-op dispatch costs
    seconds per case on the CPU)."""
    fovx = 1.0
    fovy = jtf.focal2fov(jtf.fov2focal(fovx, W), H)
    cam = RasterCamera(w2c=jnp.eye(4), proj=proj, width=W, height=H,
                       tan_fovx=math.tan(fovx / 2),
                       tan_fovy=math.tan(fovy / 2))
    proc = preprocess(means, scales, quats, cam, tile_w=tile, tile_h=tile,
                      opacity=opac,
                      colors_precomp=jnp.zeros((means.shape[0], 3)))
    op = jnp.where(proc.visible, opac, 0.0)
    qmax = 2.0 * jnp.log(jnp.maximum(255.0 * op, 1e-12)) + 0.05
    return proc, (proc.mean2d, proc.conic, qmax)


_jax_build = jax.jit(jax_build, static_argnums=(1, 2), static_argnames=(
    "max_tiles_per_splat", "max_pairs", "big_splats", "extra_tiers",
    "rank_key", "compact", "pallas_sort"))


def _setup(W, H, P, seed, tile=32, depth_ties=False):
    rng = np.random.default_rng(seed)
    means = np.stack([rng.uniform(-2, 2, P), rng.uniform(-1, 1, P),
                      rng.uniform(2, 8, P)], -1).astype(np.float32)
    if depth_ties:
        # a third of the splats share one of five depths
        idx = rng.choice(P, P // 3, replace=False)
        means[idx, 2] = rng.choice([3.0, 4.0, 4.5, 5.0, 6.0],
                                   idx.size).astype(np.float32)
    scales = np.exp(rng.uniform(-4, -1.5, (P, 3))).astype(np.float32)
    quats = rng.normal(size=(P, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    opac = rng.uniform(0.2, 0.95, P).astype(np.float32)
    fovy = jtf.focal2fov(jtf.fov2focal(1.0, W), H)
    proj = jtf.projection_matrix(0.01, 100, 1.0, fovy)
    proc, cl = _jax_prep(*map(jnp.asarray, (means, scales, quats, opac,
                                            proj)), W, H, tile)
    jcull = JCull(*cl, tile_w=tile, tile_h=tile)
    tproc = ProcessedSplats(*(torch.from_numpy(np.array(x)) for x in proc))
    tcull = CullSpec(*(torch.from_numpy(np.array(x)) for x in cl),
                     tile_w=tile, tile_h=tile)
    grid = ((W + tile - 1) // tile, (H + tile - 1) // tile)
    return proc, jcull, tproc, tcull, grid


def _assert_same(a, b):
    for f in FIELDS:
        ta = getattr(b, f)
        np.testing.assert_array_equal(ta.numpy(), np.asarray(getattr(a, f)),
                                      err_msg=f)
    assert b.point_list.dtype == torch.int32


# (W, H, P, seed, tile, depth_ties, build kwargs, expected flag): every
# case runs the JAX lax.sort path, whose lists equal the compact /
# pallas_sort ones there. Flags: None = nothing overflows, "budget" =
# max_pairs drops whole trailing splats, "k" = a tier register overflows.
CASES = {
    "rank_key_extra_tiers": (256, 128, 3000, 7, 32, False, dict(
        max_tiles_per_splat=8, max_pairs=12000, big_splats=16,
        extra_tiers=((512, 8),), rank_key=True), None),
    "two_tier_catch_all": (256, 128, 3000, 8, 32, False, dict(
        max_tiles_per_splat=4, max_pairs=20000, big_splats=1024,
        rank_key=True), None),
    "budget_drops_splats": (256, 128, 3000, 9, 32, False, dict(
        max_tiles_per_splat=8, max_pairs=3000, big_splats=16,
        extra_tiers=((512, 8),), rank_key=True), "budget"),
    "tier_register_overflow": (256, 128, 3000, 10, 32, False, dict(
        max_tiles_per_splat=2, max_pairs=12000, big_splats=4,
        extra_tiers=((16, 2),), rank_key=True), "k"),
    "depth_ties": (256, 128, 3000, 11, 32, True, dict(
        max_tiles_per_splat=8, max_pairs=12000, big_splats=16,
        extra_tiers=((512, 8),), rank_key=True), None),
    "no_cull_two_tier": (256, 128, 3000, 12, 32, False, dict(
        max_tiles_per_splat=8, max_pairs=30000, big_splats=512,
        rank_key=True, cull=False), None),
    "no_catch_all_register": (256, 128, 3000, 13, 32, False, dict(
        max_tiles_per_splat=8, max_pairs=30000, big_splats=0,
        rank_key=True), "k"),
    "unbudgeted": (256, 128, 3000, 14, 32, False, dict(
        max_tiles_per_splat=8, big_splats=512, rank_key=True), None),
    # 8x8 tiles on 256x160 = 640 tiles: (n_tiles+1) << 22 overflows int32,
    # so the rank key falls back to the (tile, depth) two-key order
    "finish_fallback_over_510_tiles": (256, 160, 1500, 15, 8, True, dict(
        max_tiles_per_splat=16, max_pairs=60000, big_splats=1500,
        rank_key=True), None),
    "depth_key_sort": (256, 128, 3000, 16, 32, True, dict(
        max_tiles_per_splat=8, max_pairs=30000, big_splats=512,
        rank_key=False), None),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_build_tile_lists_bit_identical(name):
    W, H, P, seed, tile, ties, kw, flag = CASES[name]
    kw = dict(kw)
    proc, jcull, tproc, tcull, (gx, gy) = _setup(W, H, P, seed, tile, ties)
    use_cull = kw.pop("cull", True)
    a = _jax_build(proc, gx, gy, cull=jcull if use_cull else None, **kw)
    b = build_tile_lists(tproc, gx, gy, cull=tcull if use_cull else None,
                         **kw)
    _assert_same(a, b)
    assert int(np.asarray(a.tile_counts).sum()) > 0
    assert bool(a.k_overflowed) == (flag == "k")
    assert bool(a.overflowed) == (flag is not None)


def test_compact_pallas_sort_lists_bit_identical():
    # the exact-config flags: JAX compacts and runs the bitonic engine in
    # interpret mode; the port compacts and radix-sorts
    proc, jcull, tproc, tcull, (gx, gy) = _setup(256, 128, 1000, 7)
    kw = dict(max_tiles_per_splat=8, max_pairs=4000, big_splats=16,
              extra_tiers=((512, 8),), rank_key=True)
    a = _jax_build(proc, gx, gy, cull=jcull, compact=True, pallas_sort=True,
                   **kw)
    b = build_tile_lists(tproc, gx, gy, cull=tcull, **kw)
    _assert_same(a, b)
    assert not bool(a.overflowed)


def test_cpu_takes_the_broadcast_without_k15():
    # on CPU tensors the rank-key path stays the broadcast enumeration and
    # the plain compaction: no K15 launch and no card-side fallback counted
    from langscenex_tpu_torch import _build
    from langscenex_tpu_torch.utils import profiling
    W, H, P, seed, tile, ties, kw, _ = CASES["rank_key_extra_tiers"]
    proc, jcull, tproc, tcull, (gx, gy) = _setup(W, H, P, seed, tile, ties)
    _build.reset_launch_counts()
    before = profiling.counters.get("bin.broadcast", 0)
    b = build_tile_lists(tproc, gx, gy, cull=tcull, **kw)
    assert _build.launch_counts["bin_pairs"] == 0
    assert profiling.counters.get("bin.broadcast", 0) == before
    _assert_same(_jax_build(proc, gx, gy, cull=jcull, **kw), b)


@pytest.mark.parametrize("case,takes", [
    ("default", True), ("over_510_tiles", False), ("k1_over_32", False),
    ("no_cull_growing_registers", False), ("cull_growing_registers", True),
    ("too_many_tiers", False), ("no_splats", False)])
def test_k15_takes_the_rank_key_path_within_its_limits(case, takes):
    # where the card runs K15 (one call's sizes, no device needed): the
    # rank-key path with a first tier of at most 32 slots, at most 8
    # register tiers, and ranks dense in each splat's kept slots (always
    # with the cull; without it only if no tier's register outgrows the
    # one before)
    from langscenex_tpu_torch.ops import binning
    P, n_tiles, K1, B, extra, cull = 2 ** 21, 345, 32, 256, (), True
    if case == "over_510_tiles":
        n_tiles = 640
    elif case == "k1_over_32":
        K1 = 48
    elif case.endswith("growing_registers"):
        extra, cull = ((8, 2), (32, 2)), case.startswith("cull")
    elif case == "too_many_tiers":
        extra = tuple((64, 2) for _ in range(8))
    elif case == "no_splats":
        P = 0
    tiers = binning._tiers(P, K1, n_tiles - K1, min(B, P), n_tiles, extra)
    n_slots = P * K1 + sum(b * k for b, _, k in tiers if b > 0)
    use_rank = binning._rank_key_fits(True, P, n_tiles)
    assert binning._kernel_takes(use_rank, P, K1, tiers,
                                 object() if cull else None,
                                 n_slots) == takes
