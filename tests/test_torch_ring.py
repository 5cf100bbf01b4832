"""The PyTorch port's sequence-parallel ring attention on gloo CPU ranks vs
the JAX package's ``ring_attention_sharded`` on the conftest's virtual
devices (tests/test_ring_attention.py's cases): the forward on 2 and 4
ranks with T even, uneven (the port splits T ceil/floor where JAX pads
and masks) and with a logit spike inside one shard; the gradients of
sum(out²) against dense attention and (at 4 ranks) against JAX's ring;
the tiny DiT's forward under ``sequence_parallel`` against JAX's under
its own and the unsharded forward. f32 on both sides. The ranks are spawned
(``parallel.dryrun.spawn``, a FileStore under tmp_path) and import only
the port. About 65 worker-seconds (three spawns, JAX's jits)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_threads import few_torch_threads  # noqa: F401

from langscenex_tpu.models.cogvideox import transformer as jtr
from langscenex_tpu.ops.flash_attention import \
    sequence_parallel as jsequence_parallel
from langscenex_tpu.ops.ring_attention import ring_attention_sharded
from langscenex_tpu.parallel.mesh import make_mesh as jmake_mesh
from langscenex_tpu_torch import convert
from langscenex_tpu_torch.models.cogvideox import transformer as tr
from langscenex_tpu_torch.ops import flash_attention as tfa
from langscenex_tpu_torch.ops import ring_attention as tring
from langscenex_tpu_torch.parallel import dryrun

FWD_TOL = 1e-5        # tests/test_ring_attention.py's forward bound
GRAD_TOL = 2e-4       # and its gradient bound


def _qkv(B=1, H=2, T=64, D=16, key=0):
    rng = np.random.default_rng(key)
    return tuple(rng.normal(size=(B, H, T, D)).astype(np.float32)
                 for _ in range(3))


def _jax_ring(q, k, v, n):
    return np.asarray(ring_attention_sharded(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jmake_mesh(n_data=n, n_model=1)))


def _jax_grads(q, k, v, n):
    mesh = jmake_mesh(n_data=n, n_model=1)

    def loss(q, k, v):
        return jnp.sum(jnp.square(ring_attention_sharded(q, k, v, mesh)))
    return [np.asarray(g) for g in jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))]


def _dense(q, k, v, grads=False):
    t = [torch.from_numpy(a).requires_grad_(grads) for a in (q, k, v)]
    out = tfa.attention_auto(*t, dtype=torch.float32)
    if not grads:
        return out.detach().numpy()
    return [g.numpy() for g in torch.autograd.grad(out.square().sum(), t)]


def test_shard_sizes_are_ceil_floor():
    assert tring.shard_sizes(64, 8) == [8] * 8
    assert tring.shard_sizes(50, 8) == [7, 7, 6, 6, 6, 6, 6, 6]
    assert tring.shard_sizes(5, 2) == [3, 2]


def _cases():
    spike = list(_qkv(T=64, key=3))
    spike[1][:, :, 37] = 50.0          # the softmax max in one shard only
    return {"even": (_qkv(), False), "uneven": (_qkv(T=51, key=5), False),
            "spike": (tuple(spike), False),
            "grads": (_qkv(T=33, key=7), True)}


@pytest.mark.parametrize("world", [2, 4])
def test_ring_matches_jax_and_dense(world, tmp_path):
    cases = _cases()
    res = dryrun.spawn(dryrun.ring_rank, world,
                       ("cpu", [(*c, g) for c, g in cases.values()]),
                       workdir=str(tmp_path))
    for name, ((q, k, v), with_grads), *outs in zip(
            cases, cases.values(), *res):
        want = _jax_ring(q, k, v, world)
        dense = _dense(q, k, v)
        if with_grads:
            g_dense = _dense(q, k, v, grads=True)
            # JAX's ring gradient once, at 4 ranks (its jit is ~13 s)
            g_jax = _jax_grads(q, k, v, world) if world == 4 else g_dense
        for out, grads in outs:
            assert out.shape == q.shape
            np.testing.assert_allclose(out, want, atol=FWD_TOL,
                                       rtol=FWD_TOL, err_msg=name)
            np.testing.assert_allclose(out, dense, atol=FWD_TOL,
                                       rtol=FWD_TOL, err_msg=name)
            np.testing.assert_array_equal(out, outs[0][0])
            if with_grads:
                for g, d, j in zip(grads, g_dense, g_jax):
                    np.testing.assert_allclose(g, d, atol=GRAD_TOL,
                                               rtol=GRAD_TOL, err_msg=name)
                    np.testing.assert_allclose(g, j, atol=GRAD_TOL,
                                               rtol=GRAD_TOL, err_msg=name)


def test_dit_forward_under_sequence_parallel_matches_jax(tmp_path):
    # tests/test_ring_attention.py::test_dit_forward_under_sequence_
    # parallel: the 2-layer tiny DiT, 2e-4 (its bound) against JAX's SP
    # forward and the unsharded one
    small = dict(num_heads=4, head_dim=16, in_channels=8, out_channels=4,
                 patch_size=2, text_embed_dim=16, time_embed_dim=32)
    model = jtr.CogVideoXTransformer(jtr.TransformerConfig(
        num_layers=2, attn_dtype=jnp.float32, **small))
    rng = np.random.default_rng(0)
    lat = rng.normal(size=(1, 3, 8, 8, 12)).astype(np.float32)
    txt = rng.normal(size=(1, 5, 16)).astype(np.float32)
    t = np.array([100], np.int32)
    params = model.init(jax.random.PRNGKey(0), lat, txt, t)
    dense = np.asarray(model.apply(params, lat, txt, t))
    with jsequence_parallel(jmake_mesh(n_data=4, n_model=1)):
        sp = np.asarray(jax.jit(model.apply)(params, lat, txt, t))
    sd = {k: v.numpy() for k, v in convert.cogvideox_dit_from_numpy(
        jax.tree_util.tree_map(np.asarray, params), head_dim=16,
        device="cpu").items()}
    cfg = tr.TransformerConfig(num_layers=2, attn_dtype=torch.float32,
                               **small)
    outs = dryrun.spawn(dryrun.sp_forward_rank, 4,
                        ("cpu", cfg, sd, (lat, txt, t)),
                        workdir=str(tmp_path))
    for out in outs:
        np.testing.assert_allclose(out, sp, atol=2e-4, rtol=2e-4)
        np.testing.assert_allclose(out, dense, atol=2e-4, rtol=2e-4)
        np.testing.assert_array_equal(out, outs[0])


def test_sequence_parallel_routes_attention_through_the_ring(monkeypatch):
    # attention_bthd falls through to attention_auto under SP (fa:1128-
    # 1148), so the DiT's attention takes the ring; outside it, not
    calls = []

    def fake_ring(q, k, v, mesh, scale=None):
        calls.append((tuple(q.shape), q.dtype, mesh))
        return torch.zeros_like(q)
    monkeypatch.setattr(tring, "ring_attention", fake_ring)
    q = torch.randn(1, 6, 2, 16)                  # [B, T, H, D]
    with tfa.sequence_parallel("mesh"):
        out = tfa.attention_bthd(q, q, q, dtype=torch.float32)
        tfa.attention_auto(q, q, q, dtype=torch.float32)
    assert out.shape == q.shape and not out.any()
    assert calls == [((1, 2, 6, 16), torch.float32, "mesh"),
                     ((1, 6, 2, 16), torch.float32, "mesh")]
    tfa.attention_bthd(q, q, q, dtype=torch.float32)
    assert len(calls) == 2 and tfa._SEQ_PARALLEL is None
