"""The fused LayerNormZero of the PyTorch port (the plain version of kernel
K8, what the CUDA kernel is held against on the card) vs the JAX package:
its Pallas kernel ``_lnz_fwd_pallas`` in interpret mode and its reference
math ``_lnz_ref``, at the JAX test's shapes, in f32; and the autograd
backward vs autograd through the plain formula."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from test_torch_threads import few_torch_threads  # noqa: F401

from langscenex_tpu.ops.ln_modulate import _lnz_fwd_pallas, _lnz_ref
from langscenex_tpu_torch.ops.ln_modulate import (ln_modulate,
                                                  ln_modulate_plain)

TEXT_LEN = 226


def _mk(B=2, T=700, H=256, seed=0):
    """The JAX test's inputs (tests/test_ln_modulate.py), as numpy."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(B, T, H)) * 2).astype(np.float32)
    gamma = (rng.normal(size=(H,)) * 0.5 + 1).astype(np.float32)
    beta = (rng.normal(size=(H,)) * 0.1).astype(np.float32)
    mods = [(rng.normal(size=(B, H)) * 0.3).astype(np.float32)
            for _ in range(4)]
    return [x, gamma, beta, *mods]


def test_plain_matches_jax_pallas_kernel():
    # f32 on both sides; the two sums of the statistics run in another
    # order, and the kernel composes y = n·A + C where the plain version
    # computes (n·γ + β)(1 + s) + shift: 2e-5 (the JAX kernel test's bound)
    args = _mk()
    with pltpu.force_tpu_interpret_mode():
        want = _lnz_fwd_pallas(*map(jnp.asarray, args), text_len=TEXT_LEN,
                               interpret=True)
    got = ln_modulate_plain(*map(torch.from_numpy, args), TEXT_LEN)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)


@pytest.mark.parametrize("text_len", [0, TEXT_LEN, 700])
def test_plain_matches_jax_reference(text_len):
    # the same formula in f32, the statistics summed in another order: 1e-5
    args = _mk(seed=1)
    want = _lnz_ref(*map(jnp.asarray, args), text_len)
    got = ln_modulate(*map(torch.from_numpy, args), text_len)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


def test_backward_matches_autograd_of_plain():
    # the autograd function's backward re-derives the plain formula: the
    # gradients equal autograd through it to 1e-6
    args = [torch.from_numpy(a) for a in _mk(B=1, T=300, H=128, seed=2)]
    g = torch.from_numpy(np.random.default_rng(3).normal(
        size=(1, 300, 128)).astype(np.float32))
    a1 = [a.clone().requires_grad_() for a in args]
    a2 = [a.clone().requires_grad_() for a in args]
    (ln_modulate(*a1, TEXT_LEN) * g).sum().backward()
    (ln_modulate_plain(*a2, TEXT_LEN) * g).sum().backward()
    for x, y in zip(a1, a2):
        torch.testing.assert_close(x.grad, y.grad, atol=1e-6, rtol=1e-6)


def test_rejects_mismatched_shapes():
    x, gamma, beta, *mods = map(torch.from_numpy, _mk(B=1, T=8, H=16))
    with pytest.raises(ValueError, match=r"\[B,H\]"):
        ln_modulate(x, gamma, beta, mods[0][:, :8], *mods[1:], 2)
    with pytest.raises(ValueError, match="unsupported device"):
        meta = [t.to("meta") for t in (x, gamma, beta, *mods)]
        ln_modulate(*meta, 2)
