"""The exp2 attention probes of the PyTorch port against the JAX package's
``experiments/ab_attention2.py`` on the CPU: ``flash_exp2`` (kernel
K13a, ``_exp2_kernel``) and ``flash_exp2_bf16`` (K13b,
``_exp2_bf16_kernel``) in interpret mode against the port's probes of the
same names, which run the kernels' plain versions on CPU tensors; a fault
of the reference that the port refuses; the wrappers' refusals; and the
port's ``ab_attention2`` through its ``main``.

``experiments/`` is no package, so the JAX script is loaded by its path.

Tolerances: f32 with the same rounding points and sums in another order,
2e-5. bf16: the f32 sums in another order can move a p across a bf16
rounding boundary and an output by one bf16 ulp, so o within 2^-8
relative + 1e-3."""
import importlib.util
import math
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from test_torch_threads import few_torch_threads  # noqa: F401

from langscenex_tpu_torch.experiments import ab_attention2, parse_args
from langscenex_tpu_torch.ops.flash_attention import (
    LOG2E, flash_attention_exp2_bf16_kernel, flash_attention_exp2_bf16_plain,
    flash_attention_exp2_kernel, flash_attention_exp2_plain,
    flash_attention_online_plain)

ROOT = pathlib.Path(__file__).resolve().parent.parent
SCALE = 0.125                # 1/sqrt(64), the probes' scale
F32_TOL = dict(atol=2e-5, rtol=2e-5)
BF16_TOL = dict(atol=1e-3, rtol=2 ** -8)


@pytest.fixture(scope="module")
def jab2():
    spec = importlib.util.spec_from_file_location(
        "jax_ab_attention2", ROOT / "experiments" / "ab_attention2.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _inputs(T, Tk, dtype, seed, H=2):
    """Unit-normal q [1,H,T,64] and k, v [1,H,Tk,64] (the probe's inputs)
    as JAX and torch arrays of one dtype with the same values."""
    rng = np.random.default_rng(seed)
    arrays = [rng.normal(size=(1, H, n, 64)).astype(np.float32)
              for n in (T, Tk, Tk)]
    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "f32" else torch.bfloat16
    j = [jnp.asarray(a).astype(jdt) for a in arrays]
    t = [torch.from_numpy(np.array(a, np.float32)).to(tdt) for a in j]
    return j, t


def _close(got, want, dtype):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               **(F32_TOL if dtype == "f32" else BF16_TOL))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("T,Tk,block", [
    pytest.param(200, 200, 64, id="200-200"),
    pytest.param(130, 200, 64, id="130-200"),
    pytest.param(256, 256, 128, id="256-256-128"),
    pytest.param(130, 300, 128, id="130-300-128")])
def test_flash_exp2_matches_jax(jab2, T, Tk, block, dtype):
    # JAX's flash_exp2 with square blocks of 64 rows (queries and keys
    # padded to 256, the padded keys masked before the max) or of 128, the
    # key tile of K13a's kernel (WGMMA_BLOCK_K; at Tk = 300 a masked key
    # tail), against the port's flash_exp2 on CPU tensors, K13a's plain
    # version at the same key block
    (jq, jk, jv), (tq, tk, tv) = _inputs(T, Tk, dtype, seed=T + Tk)
    with pltpu.force_tpu_interpret_mode():
        want = jab2.flash_exp2(jq, jk, jv, block_q=block, block_k=block)
    got = ab_attention2.flash_exp2(tq, tk, tv, block, block)
    assert got.shape == want.shape and got.dtype == tq.dtype
    _close(got, want, dtype)


def _xla_exp2_bf16_model(q, k, v, block):
    """K13b's recurrence with exp2 as XLA lowers it for a bf16 operand x,
    exp(bf16(bf16(ln 2) * x)) rounded to bf16, the rescale in f32; T a
    multiple of ``block``, Tk == T."""
    bf = lambda x: x.to(torch.bfloat16).float()       # noqa: E731
    T = q.shape[2]
    s = (bf(q * torch.tensor(SCALE * LOG2E, dtype=torch.bfloat16))
         @ k.float().transpose(-1, -2)).unflatten(-1, (T // block, block))
    m = s.amax(-1).cummax(-1).values
    p = bf(torch.exp(bf(bf(torch.tensor(math.log(2.0))) * bf(
        s - m[..., None]))))
    w = torch.exp2(m - m[..., -1:])
    acc = (p * w[..., None]).flatten(-2) @ v.float()
    return bf(acc / (p.sum(-1) * w).sum(-1)[..., None])


@pytest.mark.parametrize("T,block", [(192, 64), (256, 128)])
def test_flash_exp2_bf16_matches_jax(jab2, T, block):
    # JAX's flash_exp2_bf16 with whole blocks on each axis (the probe is
    # bf16): T = 192 in 64-row blocks, and T = 256 in 128-row blocks, the
    # key tile of K13b's kernel (WGMMA_BLOCK_K), against the port's at the
    # same block. The port computes p = exp2(bf16(s - m)) rounded to bf16,
    # the function of the TPU kernel as Mosaic lowers exp2 today (natively)
    # and of the H100's packed ex2. In interpret mode XLA lowers exp2(x) to
    # exp(ln2 * x) with ln 2 rounded to bf16 (0.6914, 0.25% low) and the
    # product rounded to bf16, and the reference equals that model within
    # the bf16 bound. That moves each p by up to 0.0025 |d| ln2 + 2^-9 |d|
    # ln2 relative (d = s - m, |d| about 10 at most here: 3%) in roundings
    # of either sign, so the port's o stays within 2^-6 + 2^-6 relative of
    # JAX's and its relative RMS difference within 2^-5
    (jq, jk, jv), (tq, tk, tv) = _inputs(T, T, "bf16", seed=3)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jab2.flash_exp2_bf16(jq, jk, jv, block_q=block,
                                               block_k=block), np.float32)
    model = _xla_exp2_bf16_model(tq, tk, tv, block)
    np.testing.assert_allclose(model.numpy(), want, **BF16_TOL)
    got = ab_attention2.flash_exp2_bf16(tq, tk, tv, block,
                                        block).float().numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=2 ** -6, rtol=2 ** -6)
    rel = np.sqrt(np.mean((got - want) ** 2) / np.mean(want ** 2))
    assert rel < 2 ** -5, rel


def test_jax_exp2_bf16_truncates_where_the_port_refuses(jab2):
    # the fault of the reference that the port does not copy: at T = 200
    # with 64-row blocks JAX's grid is T // 64 = 3 blocks on each axis, so
    # its rows 192..199 are never written (non-finite in interpret mode)
    # and rows < 192 attend to the first 192 keys only: they equal the
    # model of test_flash_exp2_bf16_matches_jax on the first 192 queries
    # and keys (bf16 bound) and miss the softmax over all 200 keys by far
    # more. The port raises instead, also for Tk != T
    (jq, jk, jv), (tq, tk, tv) = _inputs(200, 200, "bf16", seed=4)
    with pltpu.force_tpu_interpret_mode():
        o = np.asarray(jab2.flash_exp2_bf16(jq, jk, jv, block_q=64,
                                            block_k=64), np.float32)
    assert not np.isfinite(o[:, :, 192:]).any()
    cut = _xla_exp2_bf16_model(tq[:, :, :192], tk[:, :, :192],
                               tv[:, :, :192], 64)
    np.testing.assert_allclose(cut.numpy(), o[:, :, :192], **BF16_TOL)
    full = ab_attention2.flash_exp2(tq, tk, tv, 64, 64)
    assert float(np.abs(full.float().numpy()[:, :, :192]
                        - o[:, :, :192]).max()) > 0.05
    with pytest.raises(ValueError, match="multiple"):
        ab_attention2.flash_exp2_bf16(tq, tk, tv, 64, 64)
    with pytest.raises(ValueError, match="Tk == T"):
        ab_attention2.flash_exp2_bf16(tq[:, :, :128], tk, tv, 64, 64)


def test_exp2_plain_relations():
    # in f32 (no rounding of p) K13a's plain version is K9's o, and the
    # default CPU probe is the plain version at JAX's 1024-key block
    # exactly; K13b's bf16 exp2 moves each p by at most 2^-8 ln2 |d|
    # relative (|d| < 16 here: up to 4.3%), in independent roundings, so o
    # moves by about their RMS: relative RMS within 2^-5
    _, (q, k, v) = _inputs(150, 1100, "f32", seed=5)
    o13 = flash_attention_exp2_plain(q, k, v, SCALE, block_k=64)
    o9, _ = flash_attention_online_plain(q, k, v, SCALE, block_k=64)
    torch.testing.assert_close(o13, o9, **F32_TOL)
    torch.testing.assert_close(ab_attention2.flash_exp2(q, k, v),
                               flash_attention_exp2_plain(q, k, v, SCALE),
                               atol=0, rtol=0)
    ob = flash_attention_exp2_bf16_plain(q, k, v, SCALE, block_k=64)
    rel = float((ob - o13).norm() / o13.norm())
    assert 0 < rel < 2 ** -5


def test_exp2_wrappers_refuse_what_they_do_not_take():
    _, (q, k, v) = _inputs(16, 24, "bf16", seed=6)
    for kernel in (flash_attention_exp2_kernel,
                   flash_attention_exp2_bf16_kernel):
        with pytest.raises(ValueError, match="CUDA tensors"):
            kernel(q, k, v, SCALE)
        with pytest.raises(ValueError, match="head_dim"):
            kernel(q[..., :32], k[..., :32], v[..., :32], SCALE)
        with pytest.raises(TypeError, match="bf16"):
            kernel(q.float(), k, v, SCALE)
        with pytest.raises(ValueError, match="Tk"):
            kernel(q, k[:, :1], v, SCALE)
    meta = torch.empty(1, 2, 64, 64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ab_attention2.flash_exp2(meta, meta, meta)


def test_ab_attention2_main_on_the_cpu_and_default_to_the_card(monkeypatch):
    # the port's probe through its main at 2 heads, T = 200 (masked: the
    # bf16 probe is refused) and 256 (mask-free, with a 64-key block); the
    # CLI and main default to the card and raise without one
    out = ab_attention2.main(iters=1, device="cpu", heads=2,
                             tokens=(200, 256), block=64)
    assert sorted(out) == sorted([
        "current T=200 (masked, K9)", "exp2 T=200 (masked, K13a)",
        "current T=256 (mask-free, K9)", "exp2 T=256 (mask-free, K13a)",
        "exp2 bf16 T=256 (mask-free, K13b)"])
    assert all(np.isfinite(list(out.values())))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        parse_args(ab_attention2.__doc__, [], tokens=ab_attention2.TOKENS,
                   block=ab_attention2.BLOCK)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ab_attention2.main(iters=1, heads=2, tokens=(64,))
    a = parse_args(ab_attention2.__doc__, ["--device", "cpu", "--tokens",
                                           "100", "200", "--block", "32"],
                   tokens=ab_attention2.TOKENS, block=ab_attention2.BLOCK)
    assert (a.device, a.tokens, a.block) == (torch.device("cpu"), [100, 200],
                                             32)
