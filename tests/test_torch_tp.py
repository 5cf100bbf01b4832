"""The tensor- and data-parallel DiT of the PyTorch port on a (data,
model) mesh of gloo CPU ranks vs the JAX package on the conftest's 8
virtual devices: the forward and the CFG denoise loop (with the output
broadcast) against JAX's ``dit_sharded_apply`` and its dense model
(tests/test_multichip.py's tiny DiTs); the state_dict and adapter
shard/gather round trips, the seeded shard construction and the port's
dry run. The ranks are spawned (``parallel.dryrun.spawn``: a FileStore
under tmp_path, no TCP port, killed at their time limit) and import only
the port."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_threads import few_torch_threads  # noqa: F401

from langscenex_tpu.models.cogvideox import pipeline as jpipe
from langscenex_tpu.models.cogvideox import transformer as jtr
from langscenex_tpu.models.cogvideox.scheduler import DDIMScheduler
from langscenex_tpu.parallel import mesh as jmesh
from langscenex_tpu_torch import convert
from langscenex_tpu_torch.models.cogvideox import transformer as tr
from langscenex_tpu_torch.models.cogvideox.pipeline import PipelineConfig
from langscenex_tpu_torch.parallel import dryrun, mesh
from langscenex_tpu_torch.train import lora
from langscenex_tpu_torch.video_inference import materialize

SMALL = dict(num_heads=4, head_dim=16, in_channels=8, out_channels=4,
             patch_size=2, text_embed_dim=16, time_embed_dim=32)
SHAPE = (2, 2)            # (data, model) of the port's 4 ranks


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _port_sd(params):
    return {k: v.numpy() for k, v in convert.cogvideox_dit_from_numpy(
        _np_tree(params), head_dim=16, device="cpu").items()}


def test_tp_forward_matches_jax_sharded_and_dense(tmp_path):
    # tests/test_multichip.py::test_dit_tensor_parallel's DiT and inputs.
    # f32 on both sides; JAX's TP is a layout of the same arithmetic, the
    # port's sums its row-parallel partials in another order: 2e-4, the
    # JAX test's bound, against both JAX results
    cfg = jtr.TransformerConfig(num_layers=2, attn_dtype=jnp.float32,
                                **SMALL)
    model = jtr.CogVideoXTransformer(cfg)
    rng = np.random.default_rng(0)
    lat = rng.normal(size=(2, 3, 8, 8, 12)).astype(np.float32)
    txt = rng.normal(size=(2, 5, 16)).astype(np.float32)
    t = np.array([10, 500], np.int32)
    params = model.init(jax.random.PRNGKey(0), lat, txt, t)
    dense = np.asarray(model.apply(params, lat, txt, t))
    jm = jmesh.make_mesh(n_data=SHAPE[0], n_model=SHAPE[1])
    sharded = np.asarray(jax.jit(jmesh.dit_sharded_apply(model, jm))(
        params, lat, txt, t))
    tcfg = tr.TransformerConfig(num_layers=2, attn_dtype=torch.float32,
                                **SMALL)
    outs = dryrun.spawn(dryrun.forward_rank, 4,
                        (SHAPE, "cpu", tcfg, _port_sd(params),
                         (lat, txt, t)),
                        workdir=str(tmp_path))
    for out in outs:
        assert out.shape == dense.shape
        np.testing.assert_allclose(out, sharded, atol=2e-4, rtol=2e-4)
        np.testing.assert_allclose(out, dense, atol=2e-4, rtol=2e-4)
        np.testing.assert_array_equal(out, outs[0])


def test_tp_denoise_loop_matches_jax(tmp_path):
    # tests/test_multichip.py::test_denoise_loop_tensor_parallel: the CFG
    # pair rides data, heads and MLP ride model; 3 DDIM steps, then 4 with
    # the output broadcast every 2nd step in (0.25, 1.0). f32: 5e-4 (the
    # JAX test's bound) against JAX TP and dense; the latents at the end
    # are identical on every rank
    cfg = jtr.TransformerConfig(num_layers=1, attn_dtype=jnp.float32,
                                **SMALL)
    model = jtr.CogVideoXTransformer(cfg)
    rng = np.random.default_rng(0)
    shape = (1, 2, 4, 4, 4)
    noise = rng.normal(size=shape).astype(np.float32)
    img = rng.normal(size=shape).astype(np.float32)
    tc = rng.normal(size=(1, 3, 16)).astype(np.float32)
    tu = np.zeros_like(tc)
    lat0 = np.concatenate([np.concatenate([noise, noise], 0),
                           np.concatenate([img, img], 0)], axis=2)
    params = model.init(jax.random.PRNGKey(0), lat0,
                        np.concatenate([tu, tc], 0), np.zeros(2, np.int32))
    dense = lambda lat, txt, t: model.apply(params, lat, txt, t)  # noqa
    jm = jmesh.make_mesh(n_data=SHAPE[0], n_model=SHAPE[1])
    sh = jmesh.dit_sharded_apply(model, jm)
    tp = jax.jit(lambda lat, txt, t: sh(params, lat, txt, t))
    jcfgs = [jpipe.PipelineConfig(num_inference_steps=3,
                                  guidance_scale=6.0)]
    jcfgs.append(dataclasses.replace(jcfgs[0], num_inference_steps=4,
                                     broadcast_interval=2,
                                     broadcast_window=(0.25, 1.0)))
    want = [[np.asarray(jpipe.denoise_loop(fn, noise, img, tc, tu,
                                           DDIMScheduler(), c))
             for fn in (tp, dense)] for c in jcfgs]
    tcfgs = [PipelineConfig(num_inference_steps=3, guidance_scale=6.0)]
    tcfgs.append(dataclasses.replace(tcfgs[0], num_inference_steps=4,
                                     broadcast_interval=2,
                                     broadcast_window=(0.25, 1.0)))
    tcfg = tr.TransformerConfig(num_layers=1, attn_dtype=torch.float32,
                                **SMALL)
    res = dryrun.spawn(dryrun.denoise_rank, 4,
                       (SHAPE, "cpu", tcfg, _port_sd(params),
                        (noise, img, tc, tu), tcfgs),
                       workdir=str(tmp_path))
    for r in res:
        for got, (w_tp, w_dense) in zip(r, want):
            np.testing.assert_allclose(got, w_tp, atol=5e-4, rtol=5e-4)
            np.testing.assert_allclose(got, w_dense, atol=5e-4, rtol=5e-4)
        for got, first in zip(r, res[0]):
            np.testing.assert_array_equal(got, first)


def test_shard_gather_round_trips_and_seeded_shards():
    # shard_dit_state_dict / gather_dit_state_dict and shard_lora /
    # gather_lora give back the same tensors; a rank's seeded shard
    # (generated at full shape, sliced, dropped) equals the shard of the
    # seeded unsharded model, and a sharded model's init_lora the shard
    # of the unsharded one's: exact
    cfg = tr.TransformerConfig(num_layers=2, attn_dtype=torch.float32,
                               **{**SMALL, "head_dim": 64})
    full = materialize(tr.CogVideoXTransformer(cfg, device="meta"),
                       torch.float32, torch.device("cpu"),
                       torch.Generator().manual_seed(42))
    sd = full.state_dict()
    lcfg = lora.LoRAConfig(rank=4)
    ad = lora.init_lora(full, lcfg, torch.Generator().manual_seed(3))
    for ab in ad.values():
        ab["b"].normal_(generator=torch.Generator().manual_seed(4))
    for n in (1, 2, 4):
        shards = [convert.shard_dit_state_dict(sd, r, n) for r in range(n)]
        back = convert.gather_dit_state_dict(shards)
        assert back.keys() == sd.keys()
        assert all(torch.equal(back[k], sd[k]) for k in sd)
        ls = [convert.shard_lora(ad, r, n) for r in range(n)]
        lb = convert.gather_lora(ls)
        assert all(torch.equal(lb[s][k], ad[s][k]) for s in ad for k in "ab")
    q = "transformer_blocks.0.attn1.to_q.weight"
    assert shards[1][q].shape == (cfg.hidden // 4, cfg.hidden)
    qkv = ls[1]["transformer_blocks.0.attn1.to_qkv"]["b"]
    assert torch.equal(qkv, ad["transformer_blocks.0.attn1.to_qkv"]["b"]
                       .reshape(4, 3, 4, 64)[:, :, 1].reshape(4, -1))
    for r in range(2):
        m = mesh.Mesh(1, 2, r, "gloo", torch.device("cpu"))
        shard = mesh.materialize_sharded_dit(
            cfg, m, torch.float32, torch.Generator().manual_seed(42))
        want = convert.shard_dit_state_dict(sd, r, 2)
        got = shard.state_dict()
        assert got.keys() == want.keys()
        assert all(torch.equal(got[k], want[k]) for k in want)
        lad = lora.init_lora(shard, lcfg, torch.Generator().manual_seed(3))
        lwant = convert.shard_lora(lora.init_lora(
            full, lcfg, torch.Generator().manual_seed(3)), r, 2)
        assert all(torch.equal(lad[s][k], lwant[s][k])
                   for s in lwant for k in "ab")


def test_spawn_kills_ranks_at_its_time_limit(tmp_path):
    # a run that cannot end within its limit raises, its ranks killed
    with pytest.raises(TimeoutError, match="still running"):
        dryrun.spawn(dryrun.forward_rank, 2, ((1, 2), "cpu"), timeout=0.5,
                     workdir=str(tmp_path))


def test_port_dryrun_runs_on_the_card_unless_asked_for_the_cpu(
        monkeypatch, tmp_path):
    # as every entry point of the port: without a card the default device
    # raises, in the dry run, its CLI and a rank's mesh; the tiny DiT
    # (head dim 16, outside the attention kernels') refuses a card
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.dryrun(2, workdir=str(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.main(["--world", "2"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.rank_mesh(0, 1, str(tmp_path / "store"), 1, 1)
    with pytest.raises(ValueError, match="CPU only"):
        dryrun.dryrun(2, "cuda", workdir=str(tmp_path))


def test_port_dryrun_runs_to_its_end(tmp_path):
    # the port's _dryrun_impl / _dryrun_dit / _dryrun_sp / _dryrun_lora_tp:
    # the view-parallel field step on data=4, one full fine-tune and one
    # LoRA step of the tiny DiT on (data=2, model=2), same finite losses
    # on every rank, and the SP ring's max deviation from the unsharded
    # forward
    out = dryrun.dryrun(4, "cpu", workdir=str(tmp_path))
    assert set(out) == {"field", "dit", "lora", "sp"}
    assert all(np.isfinite(v) for v in out.values())
