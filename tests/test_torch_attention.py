"""The bounded-logit attention forward of the PyTorch port (the plain
version of kernel K5, what the CUDA kernel is held against on the card)
vs the JAX package: its native-layout Pallas forward
``_flash_fwd_impl_bthd`` in interpret mode (o and l2, in f32 and bf16,
with block sizes that leave kv and q tails), and the CPU dispatch of
``attention_bthd`` (a dense softmax)."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from test_torch_threads import few_torch_threads  # noqa: F401

from langscenex_tpu.ops.flash_attention import (_flash_fwd_impl_bthd,
                                                attention_bthd as jax_attn)
from langscenex_tpu_torch import _build
from langscenex_tpu_torch.ops.flash_attention import (attention_bthd,
                                                      attention_bthd_kernel,
                                                      attention_bthd_plain)


def _mk(B=1, T=300, H=4, D=64, seed=0):
    """The JAX kernel test's inputs (tests/test_attention_bthd.py)."""
    rng = np.random.default_rng(seed)
    q = (rng.normal(size=(B, T, H, D)) * 0.3).astype(np.float32)
    k = (rng.normal(size=(B, T, H, D)) * 0.3).astype(np.float32)
    v = rng.normal(size=(B, T, H, D)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("block_q,block_k", [(128, 128), (256, 128),
                                             (128, 256)])
def test_plain_matches_jax_kernel_f32(block_q, block_k):
    # T = 300 leaves a tail in every block size here. f32 on both sides,
    # sums in another order: 2e-5 (the JAX kernel test's bound)
    q, k, v = _mk(seed=1)
    with pltpu.force_tpu_interpret_mode():
        o, l2 = _flash_fwd_impl_bthd(*map(jnp.asarray, (q, k, v)), 0.125,
                                     block_q, block_k)
    to, tl2 = attention_bthd_plain(*map(torch.from_numpy, (q, k, v)), 0.125)
    np.testing.assert_allclose(to.numpy(), np.asarray(o), atol=2e-5,
                               rtol=2e-5)
    np.testing.assert_allclose(tl2.numpy(), np.asarray(l2)[:, :300],
                               atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("block_q,block_k", [(128, 128), (256, 128)])
def test_plain_matches_jax_kernel_bf16(block_q, block_k):
    # bf16 on both sides with the kernel's rounding points (q·scale·log2e
    # in bf16, p rounded to bf16 before PV, the normalizer summed from
    # the rounded p). The f32 sums run in another order, which can move a
    # p across a bf16 rounding boundary and the output by one bf16 ulp
    # (2^-8 relative): o within 2^-8 relative + 1e-3; l2 (f32) 1e-5.
    q, k, v = (a.astype(jnp.bfloat16) for a in _mk(seed=2))
    with pltpu.force_tpu_interpret_mode():
        o, l2 = _flash_fwd_impl_bthd(*map(jnp.asarray, (q, k, v)), 0.125,
                                     block_q, block_k)
    tq, tk, tv = (torch.from_numpy(np.asarray(a, np.float32)).to(
        torch.bfloat16) for a in (q, k, v))
    to, tl2 = attention_bthd_plain(tq, tk, tv, 0.125)
    assert to.dtype == torch.bfloat16
    np.testing.assert_allclose(to.float().numpy(),
                               np.asarray(o, np.float32), atol=1e-3,
                               rtol=2 ** -8)
    np.testing.assert_allclose(tl2.numpy(), np.asarray(l2)[:, :300],
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("q_chunk", [7, 64, 300])
def test_plain_chunking_matches_one_chunk(q_chunk):
    # query chunks change only how the f32 matmuls block their sums: 1e-6
    q, k, v = map(torch.from_numpy, _mk(T=150, H=2, seed=3))
    ref = attention_bthd_plain(q, k, v, 0.125, q_chunk=150)
    got = attention_bthd_plain(q, k, v, 0.125, q_chunk=q_chunk)
    torch.testing.assert_close(got[0], ref[0], atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(got[1], ref[1], atol=1e-6, rtol=1e-6)


def test_dispatch_matches_jax_cpu_dispatch():
    # the JAX CPU dispatch is a dense softmax (max-subtracted); the plain
    # version is exp2 without a max: equal to 2e-5 in f32
    q, k, v = _mk(T=64, seed=4)
    want = jax_attn(*map(jnp.asarray, (q, k, v)), dtype=jnp.float32)
    got = attention_bthd(*map(torch.from_numpy, (q, k, v)),
                         dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)
    # on CPU tensors it is exactly the plain version, as inside
    # _build.plain()
    o, _ = attention_bthd_plain(*map(torch.from_numpy, (q, k, v)), 0.125)
    torch.testing.assert_close(o, got, atol=0, rtol=0)
    with _build.plain():
        asked = attention_bthd(*map(torch.from_numpy, (q, k, v)),
                               dtype=torch.float32)
    torch.testing.assert_close(asked, got, atol=0, rtol=0)


def test_cpu_path_is_differentiable():
    # on CPU tensors autograd runs through the plain version: the gradient
    # of sum(o) w.r.t. v is the column sum of the normalized p
    q, k, v = (torch.from_numpy(a).requires_grad_()
               for a in _mk(T=40, H=1, seed=5))
    attention_bthd(q, k, v, dtype=torch.float32).sum().backward()
    p = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, k) / 8.0, -1)
    torch.testing.assert_close(v.grad, p.sum(2).permute(0, 2, 1)[..., None]
                               .expand_as(v), atol=1e-5, rtol=1e-5)


def test_kernel_wrapper_raises_on_what_it_does_not_take():
    q, k, v = map(torch.from_numpy, _mk(T=8, D=32))
    with pytest.raises(ValueError, match="head_dim"):
        attention_bthd_kernel(q, k, v, 0.125)
    q, k, v = map(torch.from_numpy, _mk(T=8))
    with pytest.raises(TypeError, match="bf16"):
        attention_bthd_kernel(q, k, v, 0.125)
    with pytest.raises(ValueError, match="CUDA tensors"):
        attention_bthd_kernel(*(t.to(torch.bfloat16) for t in (q, k, v)),
                              0.125)
    with pytest.raises(ValueError, match="unsupported device"):
        attention_bthd(q.to("meta"), k.to("meta"), v.to("meta"))
    with pytest.raises(ValueError, match="one shape"):
        attention_bthd(q, k[:, :4], v)
