"""The [B, H, T, D] bounded attention of the PyTorch port (the plain
version of kernel K6 and the autograd ``flash_attention`` over it and
K7's plain backward) vs the JAX package on the CPU: ``flash_attention(
bounded_logits=True)`` with its Pallas kernels in interpret mode (K6's
``_attn_kernel_nomax_t``, and the kernels K6 serves: K10's
``_attn_kernel_nomax`` and the split-kv ``_t2``/``_t3``), ``jax.grad``
through the fused backward, and the ``attention_auto`` /
``attention_bthd`` dispatch of a tensor-parallel shard."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from test_torch_threads import few_torch_threads  # noqa: F401

from langscenex_tpu.ops import flash_attention as jfa
from langscenex_tpu_torch import _build
from langscenex_tpu_torch.ops.flash_attention import (
    attention_auto, attention_bthd, flash_attention,
    flash_attention_online_plain, flash_attention_plain)

SCALE = 0.125


def _mk(T, Tk, B=1, H=2, D=64, seed=0):
    rng = np.random.default_rng(seed)
    q = (rng.normal(size=(B, H, T, D)) * 0.3).astype(np.float32)
    k = (rng.normal(size=(B, H, Tk, D)) * 0.3).astype(np.float32)
    v = rng.normal(size=(B, H, Tk, D)).astype(np.float32)
    return q, k, v


def _pin(monkeypatch, nt: bool = True):
    # another test module may leave NT_BOUNDED_FORWARD off in this worker
    monkeypatch.setattr(jfa, "NT_BOUNDED_FORWARD", nt)
    monkeypatch.setattr(jfa, "FUSED_BWD", True)


def _torch(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


SHAPES = [(256, 256), (300, 300), (130, 200), (384, 640)]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("T,Tk", SHAPES)
def test_k6_plain_matches_jax_kernel(monkeypatch, T, Tk, dtype):
    # o from flash_attention(bounded_logits=True) and l2 from its forward,
    # both K6 (_attn_kernel_nomax_t) in interpret mode. f32 on both sides,
    # sums in another order: 2e-5. bf16 with the kernel's rounding points:
    # the f32 sums in another order can move a p across a bf16 rounding
    # boundary and an output by one bf16 ulp (2^-8 relative): o within
    # 2^-8 relative + 1e-3, l2 (f32) 1e-5
    _pin(monkeypatch)
    q, k, v = _mk(T, Tk, seed=T + Tk)
    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "f32" else torch.bfloat16
    jq, jk, jv = (jnp.asarray(a).astype(jdt) for a in (q, k, v))
    with pltpu.force_tpu_interpret_mode():
        o = jfa.flash_attention(jq, jk, jv, SCALE, bounded_logits=True)
        _, l2 = jfa._flash_fwd_impl(jq, jk, jv, SCALE, 1024, 1024, True)
    to, tl2 = flash_attention_plain(*(_torch(np.asarray(a, np.float32), tdt)
                                      for a in (jq, jk, jv)), SCALE)
    assert to.dtype == tdt and tl2.shape == (2, T)
    otol = dict(atol=2e-5, rtol=2e-5) if dtype == "f32" else dict(
        atol=1e-3, rtol=2 ** -8)
    ltol = 2e-5 if dtype == "f32" else 1e-5
    np.testing.assert_allclose(to.float().numpy(), np.asarray(o, np.float32),
                               **otol)
    np.testing.assert_allclose(tl2.numpy(), np.asarray(l2)[:, :T],
                               atol=ltol, rtol=ltol)


@pytest.mark.parametrize("kernel", ["k10_f32", "k10_bf16", "t2", "t3"])
def test_kernels_served_by_k6_match_its_plain_version(monkeypatch, kernel):
    # K10 (flash_attention(bounded_logits=True) with NT_BOUNDED_FORWARD
    # off: the lane-padded PV kernel with a pad-bias column) and the
    # split-kv _t2/_t3 compute K6's function. A 2048-key block makes _t2
    # split it in halves; Tk = 2118 leaves a padded tail. Bounds as K6's
    q, k, v = _mk(256, 2118 if kernel in ("t2", "t3") else 200, seed=7)
    jdt = jnp.bfloat16 if kernel == "k10_bf16" else jnp.float32
    jq, jk, jv = (jnp.asarray(a).astype(jdt) for a in (q, k, v))
    with pltpu.force_tpu_interpret_mode():
        if kernel.startswith("k10"):
            _pin(monkeypatch, nt=False)
            o, l2 = jfa._flash_fwd_impl(jq, jk, jv, SCALE, 128, 128, True)
            o = jfa.flash_attention(jq, jk, jv, SCALE, block_q=128,
                                    block_k=128, bounded_logits=True)
        else:
            split = True if kernel == "t2" else "dual"
            o = jfa.flash_attention_nt(jq, jk, jv, SCALE, block_k=2048,
                                       split_kv=split)
            _, l2 = jfa._flash_fwd_impl_t(jq, jk, jv, SCALE, 1024, 2048,
                                          split)
    tdt = torch.bfloat16 if kernel == "k10_bf16" else torch.float32
    to, tl2 = flash_attention_plain(*(_torch(np.asarray(a, np.float32), tdt)
                                      for a in (jq, jk, jv)), SCALE)
    bf = kernel == "k10_bf16"
    np.testing.assert_allclose(to.float().numpy(), np.asarray(o, np.float32),
                               atol=1e-3 if bf else 2e-5,
                               rtol=2 ** -8 if bf else 2e-5)
    np.testing.assert_allclose(tl2.numpy(), np.asarray(l2)[:, :256],
                               atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("T,Tk", [(130, 130), (130, 200)])
def test_flash_attention_grads_match_jax(monkeypatch, T, Tk):
    # the port's flash_attention on the CPU (K6's plain forward and K7's
    # plain backward on [B, H, T, D] views) against jax.grad of the JAX
    # flash_attention(bounded_logits=True) in interpret mode (K6 forward,
    # the fused K7 backward), f32, a random output gradient: 2e-5 of the
    # largest gradient of each kind + 2e-5 relative
    _pin(monkeypatch)
    q, k, v = _mk(T, Tk, B=2, seed=11)
    do = np.random.default_rng(12).normal(size=q.shape).astype(np.float32)

    def f(q, k, v):
        return jnp.sum(jfa.flash_attention(q, k, v, SCALE, block_q=128,
                                           block_k=128,
                                           bounded_logits=True) * do)
    with pltpu.force_tpu_interpret_mode():
        want = jax.grad(f, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    o = flash_attention(*leaves, SCALE, bounded_logits=True)
    (o * torch.from_numpy(do)).sum().backward()
    for name, t, w in zip("qkv", leaves, want):
        w = np.asarray(w)
        np.testing.assert_allclose(t.grad.numpy(), w, rtol=2e-5,
                                   atol=2e-5 * np.abs(w).max(),
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_attention_auto_cpu_matches_jax(dtype):
    # the CPU branch of both dispatches is the einsum softmax (logits in
    # f32 from the dtype's operands, p in the dtype). f32: 2e-5; bf16: the
    # same roundings, sums in another order move an output by at most a
    # bf16 ulp: 2^-8 relative + 1e-3. Above the threshold and with
    # unbounded logits the CPU still takes the einsum (the card runs K9)
    q, k, v = _mk(130, 130, seed=13)
    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "f32" else torch.bfloat16
    tol = dict(atol=2e-5, rtol=2e-5) if dtype == "f32" else dict(
        atol=1e-3, rtol=2 ** -8)
    for bounded in (True, False):
        want = jfa.attention_auto(*map(jnp.asarray, (q, k, v)), SCALE,
                                  dtype=jdt, flash_threshold=64,
                                  bounded_logits=bounded)
        got = attention_auto(*map(torch.from_numpy, (q, k, v)), SCALE,
                             dtype=tdt, flash_threshold=64,
                             bounded_logits=bounded)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)


def test_attention_bthd_under_tensor_parallel_matches_jax():
    # for a TP shard attention_bthd hands [B, H, T, D] views to
    # attention_auto (on the CPU the einsum, as the JAX CPU dispatch of
    # attention_bthd always is): 2e-5 in f32. Inside _build.plain() it runs
    # K6's plain version instead, the function of the card's kernel
    q, k, v = (a.transpose(0, 2, 1, 3) for a in _mk(70, 70, seed=14))
    want = jfa.attention_bthd(*map(jnp.asarray, (q, k, v)),
                              dtype=jnp.float32)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    got = attention_bthd(tq, tk, tv, dtype=torch.float32,
                         tensor_parallel=True)
    with _build.plain():
        plain = attention_bthd(tq, tk, tv, dtype=torch.float32,
                               tensor_parallel=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)
    o, _ = flash_attention_plain(*(t.transpose(1, 2) for t in (tq, tk, tv)),
                                 SCALE)
    torch.testing.assert_close(plain, o.transpose(1, 2), atol=0, rtol=0)
    # the unbounded flash_attention, the JAX default, runs K9's plain
    # version on CPU tensors
    torch.testing.assert_close(
        flash_attention(tq, tk, tv),
        flash_attention_online_plain(tq, tk, tv, SCALE)[0], atol=0, rtol=0)
