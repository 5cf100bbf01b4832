"""The exact-softmax attention of the PyTorch port against the JAX package
on the CPU: the plain versions of kernel K9 (the online-softmax forward,
``_attn_kernel`` through ``_flash_fwd_impl(bounded_logits=False)``) and
K11 (``flash_attention_h2``) against the Pallas kernels in interpret mode;
``flash_attention(bounded_logits=False)``'s autograd against
``jax.grad``, whose backward is the split pair ``_bwd_dq_kernel`` /
``_bwd_dkv_kernel`` (K12); every split-backward branch of
``_flash_bwd_core`` against K7's plain version on the same (o, l2); the
CPU dispatch of ``attention_auto``; and the wrappers' refusals.

Tolerances: f32 on both sides with sums in another order, 2e-5. bf16 with
the same rounding points: the f32 sums in another order can move a p
across a bf16 rounding boundary and an output by one bf16 ulp, so o within
2^-8 relative + 1e-3; such a p moves l by at most one ulp of p, 2^-7 of
it, so l2 within log2(1 + 2^-7) < 1.13e-2, and its mean over the rows,
where only a few p move, within 1e-4."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from test_torch_threads import few_torch_threads  # noqa: F401

from langscenex_tpu.ops import flash_attention as jfa
from langscenex_tpu_torch import _build
from langscenex_tpu_torch.experiments import (ab_attention, ab_attention4,
                                              parse_args)
from langscenex_tpu_torch.ops.flash_attention import (
    attention_auto, flash_attention, flash_attention_backward_plain,
    flash_attention_h2, flash_attention_h2_kernel, flash_attention_h2_plain,
    KERNEL_BWD_KEYS, KERNEL_Q_TILE, flash_attention_online_kernel,
    flash_attention_online_plain, flash_attention_plain)

SCALE = 0.125
F32_TOL = dict(atol=2e-5, rtol=2e-5)
BF16_TOL = dict(atol=1e-3, rtol=2 ** -8)
L2_BF16_ATOL, L2_BF16_MEAN = 1.13e-2, 1e-4


def _mk(T, Tk, B=1, H=2, D=64, seed=0, mag=0.3):
    rng = np.random.default_rng(seed)
    q = (rng.normal(size=(B, H, T, D)) * mag).astype(np.float32)
    k = (rng.normal(size=(B, H, Tk, D)) * mag).astype(np.float32)
    v = rng.normal(size=(B, H, Tk, D)).astype(np.float32)
    return q, k, v


def _cast(arrays, dtype):
    """The same values as JAX and torch arrays of one dtype."""
    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "f32" else torch.bfloat16
    j = [jnp.asarray(a).astype(jdt) for a in arrays]
    t = [torch.from_numpy(np.array(a, np.float32)).to(tdt) for a in j]
    return j, t


def _pin(monkeypatch, nt: bool, fused: bool):
    # another test module may leave NT_BOUNDED_FORWARD off in this worker
    monkeypatch.setattr(jfa, "NT_BOUNDED_FORWARD", nt)
    monkeypatch.setattr(jfa, "FUSED_BWD", fused)


def _close(got, want, dtype):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               **(F32_TOL if dtype == "f32" else BF16_TOL))


def _close_l2(got, want, dtype):
    got, want = got.numpy(), np.asarray(want)
    if dtype == "f32":
        np.testing.assert_allclose(got, want, **F32_TOL)
    else:
        np.testing.assert_allclose(got, want, atol=L2_BF16_ATOL, rtol=0)
        assert np.abs(got - want).mean() < L2_BF16_MEAN


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("T,Tk,bk", [(256, 256, 128), (130, 70, 32),
                                     (384, 640, 256)])
def test_k9_plain_matches_jax_kernel(T, Tk, bk, dtype):
    # o and l2 of _flash_fwd_impl(bounded_logits=False), K9 in interpret
    # mode, with the plain version rescaling at JAX's key block bk: several
    # blocks at every shape, a padded kv tail (-1e9 bias column) at 70 and
    # 640 keys, a query tail at 130
    (jq, jk, jv), (tq, tk, tv) = _cast(_mk(T, Tk, seed=T + Tk), dtype)
    with pltpu.force_tpu_interpret_mode():
        o, l2 = jfa._flash_fwd_impl(jq, jk, jv, SCALE, 128, bk, False)
    to, tl2 = flash_attention_online_plain(tq, tk, tv, SCALE, block_k=bk)
    assert to.dtype == tq.dtype and tl2.shape == (2, T)
    _close(to, o, dtype)
    _close_l2(tl2, np.asarray(l2)[:, :T], dtype)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_k9_plain_large_logits_finite_and_matches_jax(dtype):
    # q, k x 20 (test_flash_attention's extreme logits): natural logits in
    # the hundreds, where the bounded softmax (K6's plain version, no
    # running max) overflows; the online one stays finite and equals JAX.
    # l2 = m + log2 l is in the thousands too: its f32 rounding is
    # relative. The f32 rounding of logits that large (about 1e-3) moves
    # the few p that matter by about 1e-3 relative, so a bf16 output may
    # move by a whole ulp at the bottom of its binade: 2^-7 relative + 1e-3
    (jq, jk, jv), (tq, tk, tv) = _cast(_mk(128, 192, H=1, seed=1, mag=20.0),
                                       dtype)
    with pltpu.force_tpu_interpret_mode():
        o, l2 = jfa._flash_fwd_impl(jq, jk, jv, SCALE, 64, 64, False)
    to, tl2 = flash_attention_online_plain(tq, tk, tv, SCALE, block_k=64)
    assert bool(torch.isfinite(to.float()).all())
    np.testing.assert_allclose(to.float().numpy(), np.asarray(o, np.float32),
                               **(F32_TOL if dtype == "f32"
                                  else dict(atol=1e-3, rtol=2 ** -7)))
    np.testing.assert_allclose(tl2.numpy(), np.asarray(l2)[:, :128],
                               atol=1e-3, rtol=2e-5)
    bounded, _ = flash_attention_plain(tq, tk, tv, SCALE)
    assert not bool(torch.isfinite(bounded.float()).all())


def test_k9_plain_block_changes_only_rounding():
    # the key block sets where the rescales fall: in f32 it moves o and l2
    # by f32 rounding only; the query chunk not at all beyond it
    _, (tq, tk, tv) = _cast(_mk(200, 300, seed=5, mag=1.0), "f32")
    ref = flash_attention_online_plain(tq, tk, tv, SCALE, block_k=300)
    for bk, chunk in ((64, 256), (1024, 256), (100, 7)):
        got = flash_attention_online_plain(tq, tk, tv, SCALE, block_k=bk,
                                           q_chunk=chunk)
        for g, r in zip(got, ref):
            torch.testing.assert_close(g, r, **F32_TOL)


@pytest.mark.parametrize("T,Tk", [(130, 130), (130, 200), (200, 70)])
def test_unbounded_autograd_matches_jax_grad(T, Tk):
    # flash_attention(bounded_logits=False) on CPU tensors (K9's plain
    # forward, K7's plain backward) against jax.grad of the JAX
    # flash_attention(bounded_logits=False) in interpret mode (K9 forward,
    # the split _bwd_dq_kernel / _bwd_dkv_kernel backward) with 64-row
    # blocks, so both axes have several blocks and a tail. f32, a random
    # output gradient: 2e-5 of the largest gradient of each kind + 2e-5
    # relative
    q, k, v = _mk(T, Tk, B=2, seed=11)
    do = np.random.default_rng(12).normal(size=q.shape).astype(np.float32)

    def f(q, k, v):
        return jnp.sum(jfa.flash_attention(q, k, v, SCALE, block_q=64,
                                           block_k=64) * do)
    with pltpu.force_tpu_interpret_mode():
        want = jax.grad(f, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    o = flash_attention(*leaves, SCALE)
    (o * torch.from_numpy(do)).sum().backward()
    for name, t, w in zip("qkv", leaves, want):
        w = np.asarray(w)
        assert t.grad.shape == w.shape
        np.testing.assert_allclose(t.grad.numpy(), w, rtol=2e-5,
                                   atol=2e-5 * np.abs(w).max(),
                                   err_msg=f"d{name}")


def test_unbounded_grads_stay_finite_where_jax_padded_rows_overflow():
    # a fault of the reference that the port does not copy: _fwd_prep pads
    # q with ones, rows as well as its column D, so in the split backward a
    # padded query row (T = 100 with 64-row blocks) has s = sum_d k_d and
    # l2 = 0, p = exp2(s) overflows once a key's sum passes 128 (here, x20
    # keys: up to 502), and ds = inf * 0 poisons dk and dv with NaN. The
    # port masks rows past T by index: every gradient finite, and dq, which
    # JAX keeps finite, equal to JAX's (f32: 2e-5 of the largest + 2e-5
    # relative)
    q, k, v = _mk(100, 128, H=1, seed=1, mag=20.0)
    do = np.random.default_rng(2).normal(size=q.shape).astype(np.float32)

    def f(q, k, v):
        return jnp.sum(jfa.flash_attention(q, k, v, block_q=64, block_k=64)
                       * do)
    with pltpu.force_tpu_interpret_mode():
        want = jax.grad(f, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    assert not np.isfinite(np.asarray(want[1])).all()
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    (flash_attention(*leaves) * torch.from_numpy(do)).sum().backward()
    assert all(bool(torch.isfinite(t.grad).all()) for t in leaves)
    w = np.asarray(want[0])
    np.testing.assert_allclose(leaves[0].grad.numpy(), w, rtol=2e-5,
                               atol=2e-5 * np.abs(w).max())


# every branch of _flash_bwd_core other than the fused one (which
# test_torch_attention_backward holds): (bounded_logits, NT_BOUNDED_FORWARD,
# FUSED_BWD), each with the l2 of its own forward
SPLIT_BRANCHES = {"k9_split": (False, True, True),
                  "bounded_split_t": (True, True, False),
                  "k10_split": (True, False, True)}


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("branch", sorted(SPLIT_BRANCHES))
def test_split_backward_branches_match_k7_plain(monkeypatch, branch, dtype):
    # the JAX split dq / dkv kernels in interpret mode against K7's plain
    # version, both fed the JAX forward's (o, l2), with 64-row blocks and
    # tails on both axes (T 130, Tk 200). f32: 2e-5 of the largest gradient
    # of each kind + 2e-5 relative. bf16: an output can land one bf16 ulp
    # away (2^-7 relative) and a ds next to a rounding midpoint round the
    # other way (2^-8 of the largest gradient), and only such outputs move:
    # relative RMS under 2^-10
    bounded, nt, fused = SPLIT_BRANCHES[branch]
    _pin(monkeypatch, nt, fused)
    q, k, v = _mk(130, 200, seed=21)
    do = np.random.default_rng(22).normal(size=q.shape).astype(np.float32)
    (jq, jk, jv, jdo), (tq, tk, tv, tdo) = _cast((q, k, v, do), dtype)
    with pltpu.force_tpu_interpret_mode():
        o, l2 = jfa._flash_fwd_impl(jq, jk, jv, SCALE, 64, 64, bounded)
        want = jfa._flash_bwd_core(jq, jk, jv, o, l2, jdo, SCALE, 64, 64,
                                   bounded)
    to = torch.from_numpy(np.array(o, np.float32)).to(tq.dtype)
    tl2 = torch.from_numpy(np.array(l2)[:, :130])
    got = flash_attention_backward_plain(tq, tk, tv, to, tl2, tdo, SCALE)
    for name, g, w in zip("qkv", got, want):
        g, w = g.float().numpy(), np.asarray(w, np.float32)
        assert g.shape == w.shape
        if dtype == "f32":
            np.testing.assert_allclose(g, w, rtol=2e-5,
                                       atol=2e-5 * np.abs(w).max(),
                                       err_msg=f"d{name}")
        else:
            np.testing.assert_allclose(g, w, rtol=2 ** -7,
                                       atol=2 ** -8 * np.abs(w).max(),
                                       err_msg=f"d{name}")
            rel_rms = np.sqrt(np.mean((g - w) ** 2) / np.mean(w ** 2))
            assert rel_rms < 2 ** -10, (name, rel_rms)


@pytest.mark.parametrize("Tk", [KERNEL_BWD_KEYS - 1, KERNEL_BWD_KEYS,
                                KERNEL_BWD_KEYS + 1])
@pytest.mark.parametrize("T", [KERNEL_Q_TILE - 1, KERNEL_Q_TILE,
                               KERNEL_Q_TILE + 1, 200])
def test_k7_plain_matches_jax_at_kernel_tile_edges(monkeypatch, T, Tk):
    # K7's plain version against JAX's backward (the K9 split branch of
    # _flash_bwd_core in interpret mode, which takes Tk != T) on the JAX
    # forward's (o, l2), at the edges of the CUDA kernel's 128-key block
    # and 64-query step, Tk above and below T. f32: 2e-5 of the largest
    # gradient of each kind + 2e-5 relative (the sums run in another order)
    _pin(monkeypatch, True, True)
    q, k, v = _mk(T, Tk, seed=23)
    do = np.random.default_rng(24).normal(size=q.shape).astype(np.float32)
    (jq, jk, jv, jdo), (tq, tk, tv, tdo) = _cast((q, k, v, do), "f32")
    with pltpu.force_tpu_interpret_mode():
        o, l2 = jfa._flash_fwd_impl(jq, jk, jv, SCALE, 64, 64, False)
        want = jfa._flash_bwd_core(jq, jk, jv, o, l2, jdo, SCALE, 64, 64,
                                   False)
    to = torch.from_numpy(np.array(o, np.float32))
    tl2 = torch.from_numpy(np.array(l2)[:, :T])
    got = flash_attention_backward_plain(tq, tk, tv, to, tl2, tdo, SCALE)
    for name, g, w in zip("qkv", got, want):
        g, w = g.numpy(), np.asarray(w, np.float32)
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=2e-5,
                                   atol=2e-5 * np.abs(w).max(),
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("T,Tk", [(256, 256), (384, 640), (130, 70)])
def test_k11_plain_matches_jax_kernel(T, Tk, dtype):
    # flash_attention_h2 (K11) in interpret mode with 128-row blocks
    # (test_flash_attention's shapes, 4 heads) against the plain version
    # at the same key block. The port takes odd B·H: its first 3 heads are
    # held against JAX's 4
    (jq, jk, jv), (tq, tk, tv) = _cast(_mk(T, Tk, H=4, seed=T + 2 * Tk),
                                       dtype)
    with pltpu.force_tpu_interpret_mode():
        o = jfa.flash_attention_h2(jq, jk, jv, SCALE, block_q=128,
                                   block_k=128)
    _close(flash_attention_h2_plain(tq, tk, tv, SCALE, block_k=128), o,
           dtype)
    odd = flash_attention_h2_plain(tq[:, :3], tk[:, :3], tv[:, :3], SCALE,
                                   block_k=128)
    _close(odd, np.asarray(o, np.float32)[:, :3], dtype)


def test_k11_large_logits_and_default_entry():
    # q, k x 20 with 64-row blocks: finite and equal to JAX (f32). The
    # entry's CPU path is the plain version at JAX's default key block 512
    q, k, v = _mk(128, 128, seed=1, mag=20.0)
    with pltpu.force_tpu_interpret_mode():
        o = jfa.flash_attention_h2(*map(jnp.asarray, (q, k, v)), block_q=64,
                                   block_k=64)
        o_def = jfa.flash_attention_h2(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    got = flash_attention_h2_plain(tq, tk, tv, SCALE, block_k=64)
    assert bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.numpy(), np.asarray(o), **F32_TOL)
    np.testing.assert_allclose(flash_attention_h2(tq, tk, tv).numpy(),
                               np.asarray(o_def), **F32_TOL)


@pytest.mark.parametrize("bounded", [False, True])
def test_attention_auto_cpu_dispatch_matches_jax(bounded):
    # above the threshold the CPU still takes the einsum softmax, as JAX's
    # CPU dispatch does; bf16 operands and p: 2^-8 relative + 1e-3
    q, k, v = _mk(96, 80, seed=31)
    want = jfa.attention_auto(*map(jnp.asarray, (q, k, v)), SCALE,
                              flash_threshold=64, bounded_logits=bounded)
    got = attention_auto(*map(torch.from_numpy, (q, k, v)), SCALE,
                         flash_threshold=64, bounded_logits=bounded)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **BF16_TOL)


def test_unbounded_flash_attention_on_cpu_runs_the_plain_versions():
    # the forward is K9's plain version at JAX's default block of 1024
    # keys, exactly, and no kernel is launched
    _, (tq, tk, tv) = _cast(_mk(70, 1100, seed=32), "bf16")
    _build.reset_launch_counts()
    got = flash_attention(tq, tk, tv)
    want, _ = flash_attention_online_plain(tq, tk, tv, SCALE, block_k=1024)
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    assert not any(_build.launch_counts.values())


def test_wrappers_refuse_what_they_do_not_take():
    _, (q, k, v) = _cast(_mk(16, 24, seed=33), "bf16")
    for kernel in (flash_attention_online_kernel, flash_attention_h2_kernel):
        with pytest.raises(ValueError, match="CUDA tensors"):
            kernel(q, k, v, SCALE)
        with pytest.raises(ValueError, match="head_dim"):
            kernel(q[..., :32], k[..., :32], v[..., :32], SCALE)
        with pytest.raises(TypeError, match="bf16"):
            kernel(q.float(), k, v, SCALE)
        with pytest.raises(ValueError, match="Tk"):
            kernel(q, k[:, :1], v, SCALE)
    with pytest.raises(ValueError, match="forward only"):
        flash_attention_h2(q.requires_grad_(), k, v)
    with torch.no_grad():
        assert flash_attention_h2(q, k, v).shape == q.shape


def test_experiments_run_at_a_small_shape_and_default_to_the_card(
        monkeypatch):
    # the ported ab_attention / ab_attention4 through their main on the CPU
    # (the plain versions, host-clock times) at 2 heads x 96 tokens; the
    # exact and bounded forwards agree on unit-normal inputs within a bf16
    # ulp of |o| <= 4 (2^-6). Without a card the CLI's default device
    # raises
    out = ab_attention.main(iters=1, device="cpu", heads=2, tokens=96)
    assert len(out) == 2 and all(np.isfinite(list(out.values())))
    out4 = ab_attention4.main(iters=1, device="cpu", heads=2, tokens=96)
    assert len(out4) == 5 and all(np.isfinite(list(out4.values())))
    assert out4["max_abs_diff"] <= 2 ** -6
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        parse_args(ab_attention.__doc__, [])
    assert parse_args(ab_attention4.__doc__,
                      ["--device", "cpu"]).device == torch.device("cpu")
