"""The bounded-logit attention backward of the PyTorch port (the plain
version of kernel K7, what the CUDA kernel is held against on the card)
vs the JAX package: its fused Pallas backward ``_flash_bwd_core`` in
interpret mode, fed the JAX forward's (o, l2), in f32 and bf16 with
query and key tails; chunk-size invariance; and ``attention_bthd``'s
autograd on the CPU against ``jax.grad`` of the JAX CPU dispatch."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from test_torch_threads import few_torch_threads  # noqa: F401

from langscenex_tpu.ops import flash_attention as jfa
from langscenex_tpu_torch.ops.flash_attention import (
    FlashBTHDFn, attention_bthd, attention_bthd_backward_kernel,
    attention_bthd_backward_plain, attention_bthd_plain)

SCALE = 0.125


def _mk(B=2, T=130, H=2, D=64, seed=0):
    rng = np.random.default_rng(seed)
    q = (rng.normal(size=(B, T, H, D)) * 0.3).astype(np.float32)
    k = (rng.normal(size=(B, T, H, D)) * 0.3).astype(np.float32)
    v = rng.normal(size=(B, T, H, D)).astype(np.float32)
    do = rng.normal(size=(B, T, H, D)).astype(np.float32)
    return q, k, v, do


def _jax_fused(monkeypatch, q, k, v, do, block):
    """(o, l2, dq, dk, dv) of the JAX package: the native-layout forward
    and the fused backward, both in interpret mode, with the fused branch
    pinned (another test module may leave NT_BOUNDED_FORWARD off in this
    worker, which would route the backward through the split kernels)."""
    monkeypatch.setattr(jfa, "NT_BOUNDED_FORWARD", True)
    monkeypatch.setattr(jfa, "FUSED_BWD", True)
    tr = lambda x: x.transpose(0, 2, 1, 3)              # noqa: E731
    with pltpu.force_tpu_interpret_mode():
        o, l2 = jfa._flash_fwd_impl_bthd(q, k, v, SCALE, block, block)
        dq, dk, dv = jfa._flash_bwd_core(tr(q), tr(k), tr(v), tr(o), l2,
                                         tr(do), SCALE, block, block, True)
    return (np.asarray(o, np.float32), np.asarray(l2)[:, :q.shape[1]],
            *(np.asarray(tr(g), np.float32) for g in (dq, dk, dv)))


def _port(q, k, v, do, o, l2, dtype):
    t = lambda a: torch.from_numpy(np.array(a, np.float32)).to(dtype)  # noqa
    return [g.float().numpy() for g in attention_bthd_backward_plain(
        t(q), t(k), t(v), t(o), torch.tensor(l2), t(do), SCALE)]


@pytest.mark.parametrize("T", [130, 70])
def test_plain_backward_matches_jax_fused_kernel_f32(monkeypatch, T):
    # 64-row blocks leave a query and a key tail at both T. f32 on both
    # sides; the sums run in another order: 2e-5 of the largest gradient
    # of each kind + 2e-5 relative
    q, k, v, do = _mk(T=T, seed=1)
    o, l2, *want = _jax_fused(monkeypatch, *map(jnp.asarray, (q, k, v, do)),
                              64)
    got = _port(q, k, v, do, o, l2, torch.float32)
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(g, w, rtol=2e-5,
                                   atol=2e-5 * np.abs(w).max(),
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("T", [130, 70])
def test_plain_backward_matches_jax_fused_kernel_bf16(monkeypatch, T):
    # bf16 on both sides with K7's rounding points (q' in bf16, ds and the
    # p of the dv product rounded to bf16, outputs rounded to bf16). The
    # f32 sums run in another order, so an output can land one bf16 ulp
    # away (at most 2^-7 relative), and a ds next to a rounding midpoint
    # can round the other way, moving its sum by 2^-8 of that one term:
    # 2^-7 relative + 2^-8 of the largest gradient of each kind. Only
    # outputs next to a rounding midpoint move at all, so the relative RMS
    # difference stays under 2^-10 (a dropped 64-row tile would move it
    # by about sqrt(64 / T) > 0.7)
    q, k, v, do = (a.astype(jnp.bfloat16) for a in _mk(T=T, seed=2))
    o, l2, *want = _jax_fused(monkeypatch, *map(jnp.asarray, (q, k, v, do)),
                              64)
    got = _port(q, k, v, do, o, l2, torch.bfloat16)
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(g, w, rtol=2 ** -7,
                                   atol=2 ** -8 * np.abs(w).max(),
                                   err_msg=f"d{name}")
        rel_rms = np.sqrt(np.mean((g - w) ** 2) / np.mean(w ** 2))
        assert rel_rms < 2 ** -10, (name, rel_rms)


@pytest.mark.parametrize("q_chunk", [7, 64, 129])
def test_plain_backward_chunking_matches_one_chunk(q_chunk):
    # query chunks change only how the f32 matmuls block their sums: 1e-5
    q, k, v, do = map(torch.from_numpy, _mk(B=1, T=129, seed=3))
    o, l2 = attention_bthd_plain(q, k, v, SCALE)
    ref = attention_bthd_backward_plain(q, k, v, o, l2, do, SCALE,
                                        q_chunk=129)
    got = attention_bthd_backward_plain(q, k, v, o, l2, do, SCALE,
                                        q_chunk=q_chunk)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, atol=1e-5, rtol=1e-5)


def test_autograd_matches_jax_grad_of_cpu_dispatch():
    # attention_bthd on CPU tensors: FlashBTHDFn with the plain forward and
    # the plain backward, against jax.grad of the JAX CPU attention_bthd (a
    # max-subtracted dense softmax) in f32: 2e-5 of the largest gradient
    q, k, v, do = _mk(B=1, T=48, H=2, seed=4)

    def jloss(q, k, v):
        return jnp.sum(jfa.attention_bthd(q, k, v, dtype=jnp.float32)
                       * jnp.asarray(do))
    want = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = attention_bthd(tq, tk, tv, dtype=torch.float32)
    (out * torch.from_numpy(do)).sum().backward()
    for g, w in zip((tq.grad, tk.grad, tv.grad), want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4,
                                   atol=2e-5 * np.abs(w).max())


def test_autograd_function_runs_the_plain_backward_on_cpu():
    # the autograd function's gradients are exactly the plain backward's
    q, k, v, do = map(torch.from_numpy, _mk(B=1, T=40, H=2, seed=5))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    FlashBTHDFn.apply(*leaves, SCALE).backward(do)
    o, l2 = attention_bthd_plain(q, k, v, SCALE)
    want = attention_bthd_backward_plain(q, k, v, o, l2, do, SCALE)
    for leaf, w in zip(leaves, want):
        torch.testing.assert_close(leaf.grad, w, atol=0, rtol=0)


def test_backward_kernel_wrapper_raises_on_what_it_does_not_take():
    q, k, v, do = (torch.from_numpy(a).to(torch.bfloat16)
                   for a in _mk(B=1, T=8, H=2))
    l2 = torch.zeros(2, 8)
    with pytest.raises(ValueError, match="CUDA tensors"):
        attention_bthd_backward_kernel(q, k, v, q, l2, do, SCALE)
    with pytest.raises(TypeError, match="bf16"):
        attention_bthd_backward_kernel(q.float(), k, v, q, l2, do, SCALE)
    with pytest.raises(ValueError, match="head_dim"):
        attention_bthd_backward_kernel(q[..., :32], k[..., :32],
                                       v[..., :32], q[..., :32], l2,
                                       do[..., :32], SCALE)
    with pytest.raises(ValueError, match="l2"):
        attention_bthd_backward_kernel(q, k, v, q, None, do, SCALE)
