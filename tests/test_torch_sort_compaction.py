"""PyTorch port of the pair sort (kernel K4) and stream compaction (kernel
K3) vs the JAX package. On the CPU the wrappers run their plain versions;
the JAX side runs lax.sort and the Pallas kernels in interpret mode. The
kernels themselves are held against the plain versions on a CUDA device
in test_torch_kernels_gpu.py and chip_smoke.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_threads import few_torch_threads  # noqa: F401

from langscenex_tpu.ops.binning import _depth_perm as jax_depth_perm
from langscenex_tpu.ops.compaction import compact_pairs as jax_compact
from langscenex_tpu.ops.compaction import compact_pairs_ref
from langscenex_tpu.ops.sort_engine import bitonic_sort_pairs
from langscenex_tpu_torch import _build
from langscenex_tpu_torch.ops.binning import _depth_perm
from langscenex_tpu_torch.ops.compaction import compact_pairs
from langscenex_tpu_torch.ops.sort_engine import (SORT_TILE, sort_pairs,
                                                  sort_pairs_plain,
                                                  sort_scratch_words)

SENT = 345 << 22                 # tile sentinel of a 720x480 / 32x32 grid


def _pair_stream(rng, n, n_valid, n_splats=100_000):
    """Binning-like stream: unique valid keys below SENT, a uniform
    (SENT, n_splats) sentinel for the rest, shuffled."""
    key = np.full(n, SENT, np.int32)
    key[:n_valid] = rng.choice(SENT, n_valid, replace=False)
    sid = np.full(n, n_splats, np.int32)
    sid[:n_valid] = rng.integers(0, n_splats, n_valid)
    order = rng.permutation(n)
    return key[order], sid[order]


def _sort_keys(rng, case):
    """int32 keys of one case: its stream and its length."""
    n = {"empty": 0, "one": 1, "tile_below": SORT_TILE - 1,
         "tile": SORT_TILE, "tile_above": SORT_TILE + 1}.get(case, 5000)
    if case == "ties":
        return rng.integers(0, 40, n).astype(np.int32)
    if case == "unique":
        return (rng.permutation(n) * 7919).astype(np.int32)
    if case == "equal":
        return np.full(n, -7, np.int32)
    if case == "depth":             # bitcast positive f32 and +inf: a
        d = rng.uniform(2.0, 10.0, n).astype(np.float32)  # skewed top digit
        d[rng.uniform(size=n) < 0.1] = np.inf
        return d.view(np.int32)
    if case == "top":               # f32 in [2, 4): the top digit is 0x40
        return rng.uniform(2.0, 4.0, n).astype(np.float32).view(np.int32)
    if case == "extremes":          # INT32_MIN / INT32_MAX, mixed signs
        k = rng.integers(-2 ** 31, 2 ** 31 - 1, n, dtype=np.int64)
        k[rng.uniform(size=n) < 0.1] = -2 ** 31
        k[rng.uniform(size=n) < 0.1] = 2 ** 31 - 1
        return k.astype(np.int32)
    return rng.integers(-2 ** 31, 2 ** 31 - 1, n).astype(np.int32)


@pytest.mark.parametrize("case", ["ties", "unique", "negative", "empty",
                                  "equal", "depth", "top", "extremes", "one",
                                  "tile_below", "tile", "tile_above"])
def test_plain_sort_matches_stable_lax_sort(case):
    # stable on equal keys: identical to lax.sort((key, val), num_keys=1),
    # also on the streams the onesweep kernel is sensitive to (every digit
    # equal, a skewed top digit, a constant top digit over varying lower
    # digits, the int32 extremes) and at one, one below, at and one above
    # its tile of keys
    rng = np.random.default_rng(0)
    key = _sort_keys(rng, case)
    n = key.size
    val = rng.integers(0, 1 << 30, n).astype(np.int32)
    rk, rv = jax.lax.sort((jnp.asarray(key), jnp.asarray(val)), num_keys=1)
    tk, tv = sort_pairs(torch.from_numpy(key), torch.from_numpy(val))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(rk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(rv))


@pytest.mark.parametrize("n", [0, 1, SORT_TILE - 1, SORT_TILE,
                               SORT_TILE + 1, 1 << 19])
def test_sort_scratch_words_fits_the_kernel_layout(n):
    # the digit histograms (4 x 256), 16 ticket words, a status word per
    # (pass, tile, digit) and the ping-pong keys and values, in that order
    # (csrc/sort.cu lays out its one scratch tensor so)
    n_tiles = -(-n // SORT_TILE)
    words = sort_scratch_words(n)
    assert words == 4 * 256 + 16 + 4 * 256 * n_tiles + 2 * n
    assert (words - 2 * n) % 4 == 0       # ping-pong buffers 16-byte aligned
    if n:
        assert n_tiles * SORT_TILE >= n > (n_tiles - 1) * SORT_TILE


def test_plain_sort_matches_bitonic_engine():
    # unique valid keys + a uniform sentinel tail: the engine's
    # observability contract, exact over the whole stream
    rng = np.random.default_rng(1)
    key, sid = _pair_stream(rng, 2048, 1500)
    bk, bs = bitonic_sort_pairs(jnp.asarray(key), jnp.asarray(sid),
                                interpret=True, s_block=1024)
    tk, ts = sort_pairs_plain(torch.from_numpy(key), torch.from_numpy(sid))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(bk))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(bs))


def test_depth_perm_matches_engine_with_ties_and_inf():
    # bitcast f32 depth keys with forced ties and culled +inf rows: the
    # stable radix order equals the engine's tie_sid order
    rng = np.random.default_rng(2)
    P = 3000
    depth = rng.uniform(2.0, 10.0, P).astype(np.float32)
    depth[rng.integers(0, P, 300)] = np.float32(5.25)
    dkey = np.where(rng.uniform(size=P) < 0.1, np.float32(np.inf), depth)
    sid = np.arange(P, dtype=np.int32)
    ref = jax_depth_perm(jnp.asarray(dkey), jnp.asarray(sid),
                         use_engine=True, interpret=True)
    got = _depth_perm(torch.from_numpy(dkey), torch.from_numpy(sid),
                      sort=sort_pairs_plain)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_plain_compaction_matches_pallas_after_sort():
    # the TPU kernel's in-row order is arbitrary: compare sorted streams
    rng = np.random.default_rng(3)
    key, sid = _pair_stream(rng, 20000, 6000)
    budget = 8000
    jk, js = jax_compact(jnp.asarray(key), jnp.asarray(sid), sent_min=SENT,
                         budget=budget, sent_fill_key=SENT,
                         sent_fill_sid=100_000, interpret=True)
    tk, ts = compact_pairs(torch.from_numpy(key), torch.from_numpy(sid),
                           SENT, budget, SENT, 100_000)
    assert tk.shape == (budget,)
    jk, js = jax.lax.sort((jk, js), num_keys=1)
    tk, ts = sort_pairs_plain(tk, ts)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk)[:budget])
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js)[:budget])
    assert np.all(np.asarray(jk)[budget:] == SENT)


@pytest.mark.parametrize("out_len", [20000, 12000, 25000])
def test_plain_compaction_matches_argsort_reference(out_len):
    # order-preserving: equal to compact_pairs_ref slot for slot, cut or
    # sentinel-padded to out_len
    rng = np.random.default_rng(4)
    key, sid = _pair_stream(rng, 20000, 6000)
    rk, rs = compact_pairs_ref(jnp.asarray(key), jnp.asarray(sid), SENT,
                               SENT, 100_000)
    rk, rs = np.asarray(rk), np.asarray(rs)
    pad = max(0, out_len - rk.size)
    rk = np.concatenate([rk, np.full(pad, SENT, np.int32)])[:out_len]
    rs = np.concatenate([rs, np.full(pad, 100_000, np.int32)])[:out_len]
    tk, ts = compact_pairs(torch.from_numpy(key), torch.from_numpy(sid),
                           SENT, out_len, SENT, 100_000)
    np.testing.assert_array_equal(tk.numpy(), rk)
    np.testing.assert_array_equal(ts.numpy(), rs)


def test_wrappers_run_plain_on_cpu_and_check_inputs():
    _build.reset_launch_counts()
    k = torch.tensor([3, 1, 2], dtype=torch.int32)
    v = torch.tensor([0, 1, 2], dtype=torch.int32)
    assert sort_pairs(k, v)[1].tolist() == [1, 2, 0]
    assert compact_pairs(k, v, 3, 3, 9, 9)[0].tolist() == [1, 2, 9]
    assert _build.launch_counts == {"sort_pairs": 0, "compact_pairs": 0,
                                    "blend_forward": 0, "blend_backward": 0,
                                    "flash_attention": 0,
                                    "flash_attention_bhtd": 0,
                                    "flash_attention_backward": 0,
                                    "ln_modulate": 0,
                                    "flash_attention_online": 0,
                                    "flash_attention_h2": 0,
                                    "flash_attention_exp2": 0,
                                    "flash_attention_exp2_bf16": 0,
                                    "gather_rows": 0, "exp2_bf16x2": 0,
                                    "knn_select": 0, "bin_pairs": 0}
    with pytest.raises(TypeError):
        sort_pairs(k.long(), v)
    with pytest.raises(ValueError):
        compact_pairs(k, v[:2], 3, 3, 9, 9)
