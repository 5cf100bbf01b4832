"""The row gather of the PyTorch port against the JAX package's
``experiments/ab_gather2.py`` on the CPU: the Pallas gather of
``pallas_gather`` (kernel K13c, ``kern``) in interpret mode and the XLA
gather of ``xla_gather`` against the port's ``kernel_gather`` (K13c's
plain version on CPU tensors) and ``library_gather``
(``torch.index_select``), on the script's own numpy draws; indices outside
the table; the refusals; and the port's ``ab_gather2`` through its
``main``.

``experiments/`` is no package, so the JAX script is loaded by its path.
Each script's ``timed`` is replaced by one that records the timed
function's output, and its table cut from P = 100,000 to 1,000 rows. A
gather moves bits: every comparison is exact."""
import importlib.util
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from test_torch_threads import few_torch_threads  # noqa: F401

from langscenex_tpu_torch.experiments import ab_gather2
from langscenex_tpu_torch.ops.gather import (gather_rows, gather_rows_kernel,
                                             gather_rows_plain)

ROOT = pathlib.Path(__file__).resolve().parent.parent
P_SMALL = 1000


@pytest.fixture
def scripts(monkeypatch):
    """(JAX script, port script, record): both with P = 1,000 and a
    ``timed`` that runs the timed function once and appends (function,
    arguments, output) to ``record``."""
    spec = importlib.util.spec_from_file_location(
        "jax_ab_gather2", ROOT / "experiments" / "ab_gather2.py")
    jmod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jmod)
    record = []

    def timed(*a, **_):
        fn, args = (a[1], a[2]) if isinstance(a[0], str) else (a[0], a[1])
        record.append((fn, args, fn(*args)))
        return 1.0
    for mod in (jmod, ab_gather2):
        monkeypatch.setattr(mod, "P", P_SMALL)
        monkeypatch.setattr(mod, "timed", timed)
    return jmod, ab_gather2, record


def _bits(x) -> np.ndarray:
    """The raw bits of an f32 or bf16 array (JAX or torch)."""
    if isinstance(x, torch.Tensor):
        x = x.view(torch.int16 if x.dtype == torch.bfloat16 else torch.int32)
        return x.numpy()
    x = np.asarray(x)
    return x.view(np.int16 if x.dtype.itemsize == 2 else np.int32)


@pytest.mark.parametrize("bf16", [False, True])
def test_pallas_gather_matches_kernel_gather(scripts, bf16):
    # the JAX script's Pallas gather (grid of A / 512 chunks, in-kernel
    # jnp.take from the whole table) at A = 1,024, W = 24 against the
    # port's kernel_gather on the same draws: table, indices and the
    # [A / 512, 512, W] output bit for bit
    jmod, port, record = scripts
    with pltpu.force_tpu_interpret_mode():
        jmod.pallas_gather(1024, 24, table_bf16=bf16)
    port.kernel_gather(1024, 24, table_bf16=bf16, device="cpu")
    assert len(record) == 2, "the Pallas gather failed (the script prints it)"
    (_, (jtab, jidx), want), (_, (ttab, tidx), got) = record
    assert got.shape == want.shape == (2, 512, 24)
    np.testing.assert_array_equal(_bits(ttab), _bits(jtab))
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("W", [8, 24, 128])
def test_xla_gather_matches_library_gather(scripts, W):
    # the JAX script's XLA row gather (jnp.take of a [P + 1, W] table)
    # against the port's torch.index_select on the same draws, and K13c's
    # plain version on them too
    jmod, port, record = scripts
    jmod.xla_gather(2048, W)
    port.library_gather(2048, W, device="cpu")
    (_, _, want), (_, (tab, idx), got) = record
    np.testing.assert_array_equal(_bits(got), _bits(want))
    np.testing.assert_array_equal(_bits(gather_rows_plain(tab, idx)),
                                  _bits(want))


@pytest.mark.parametrize("bf16", [False, True])
def test_indices_outside_the_table_follow_jax(scripts, bf16):
    # the Pallas gather's jnp.take on indices outside [0, R) (R = P + 8 =
    # 1,008 rows): in interpret mode an index in [-R, 0) counts from the
    # end and any other gives a row of NaN ("fill" mode). The port's plain
    # version (which the kernel follows) gives the same rows, NaN where
    # JAX's are NaN
    jmod, _, record = scripts
    with pltpu.force_tpu_interpret_mode():
        jmod.pallas_gather(1024, 24, table_bf16=bf16)
        f, (jtab, jidx), _ = record[0]
        idx = np.array(jidx)
        idx[:8] = [-1, -1008, -1009, 1007, 1008, 5000, 2 ** 31 - 1, -2 ** 31]
        want = np.asarray(f(jtab, jnp.asarray(idx)), np.float32)
    want = want.reshape(1024, 24)
    tab = torch.from_numpy(np.array(jtab, np.float32)).to(
        torch.bfloat16 if bf16 else torch.float32)
    got = gather_rows_plain(tab, torch.from_numpy(idx)).float().numpy()
    nan = np.isnan(want).all(1)
    np.testing.assert_array_equal(np.flatnonzero(nan), [2, 4, 5, 6, 7])
    np.testing.assert_array_equal(np.isnan(got).all(1), nan)
    np.testing.assert_array_equal(got[~nan], want[~nan])
    np.testing.assert_array_equal(got[0], tab[-1].float().numpy())


def test_gather_refuses_what_it_does_not_take():
    tab = torch.zeros(10, 24)
    idx = torch.zeros(1024, dtype=torch.int32)
    assert gather_rows(tab, idx).shape == (2, 512, 24)
    with pytest.raises(ValueError, match="multiple of 512"):
        gather_rows(tab, idx[:1000])
    with pytest.raises(TypeError, match="int32"):
        gather_rows(tab, idx.long())
    with pytest.raises(TypeError, match="f32 or bf16"):
        gather_rows(tab.double(), idx)
    with pytest.raises(ValueError, match=r"\[R, W\]"):
        gather_rows(tab[0], idx)
    with pytest.raises(ValueError, match=r"\[R, W\]"):
        gather_rows(tab[:0], idx)
    with pytest.raises(ValueError, match="CUDA tensors"):
        gather_rows_kernel(tab, idx)
    with pytest.raises(ValueError, match="unsupported device"):
        gather_rows(tab.to("meta"), idx.to("meta"))


def test_ab_gather2_main_on_the_cpu_and_default_to_the_card(monkeypatch):
    # the port's probe through its main with a 1,000-row table and small
    # A (host-clock times on the CPU); without a card it raises
    monkeypatch.setattr(ab_gather2, "P", P_SMALL)
    out = ab_gather2.main(iters=1, device="cpu", sizes=(512, 1024),
                          widths=(8,), kernel_a=1024)
    assert sorted(out) == sorted([
        "index_select A=512 W=24", "index_select A=1024 W=24",
        "index_select A=1024 W=8", "gather_rows A=1024 W=24 f32",
        "gather_rows A=1024 W=24 bf16"])
    assert all(np.isfinite(list(out.values())))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ab_gather2.main(iters=1, sizes=(512,))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ab_gather2.kernel_gather(512)
