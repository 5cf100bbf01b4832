"""The DiT fine-tune slice of the PyTorch port vs the JAX package on the
CPU, in f32 on the tiny DiT: the optimizer and its schedule against
optax, one full fine-tune step and one LoRA step against JAX from one
state with JAX's own draws of t and the noise (loss, grad_norm, updated
parameters), min-SNR, EMA, remat, the checkpoint round trip and resume,
the LoRA adapters (count, identity at init, merge-free == merged,
export), the full-scale adapter count, the datasets, build_batch
and encoders, and the fine-tune CLI."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_threads import few_torch_threads  # noqa: F401

from langscenex_tpu import finetune as jft
from langscenex_tpu.models.cogvideox import datasets as jds
from langscenex_tpu.models.cogvideox import transformer as jtr
from langscenex_tpu.train import dit as jdit
from langscenex_tpu.train import lora as jlora
from langscenex_tpu_torch import convert, finetune
from langscenex_tpu_torch.models.cogvideox import datasets
from langscenex_tpu_torch.models.cogvideox import transformer as tr
from langscenex_tpu_torch.models.cogvideox import vae
from langscenex_tpu_torch.models.t5 import TextEncoder
from langscenex_tpu_torch.train import checkpoint, dit, lora

# tests/test_dit_train.py's TINY DiT and batch
J_TINY = jtr.TransformerConfig(num_layers=2, num_heads=4, head_dim=16,
                               in_channels=8, out_channels=4, patch_size=2,
                               text_embed_dim=16, time_embed_dim=32,
                               attn_dtype=jnp.float32)
T_TINY = tr.TransformerConfig(num_layers=2, num_heads=4, head_dim=16,
                              in_channels=8, out_channels=4, patch_size=2,
                              text_embed_dim=16, time_embed_dim=32,
                              attn_dtype=torch.float32)
# two steps: the learning rate is 0 at the first (warmup from 0)
TCFG = dict(lr=1e-3, warmup_steps=1, total_steps=10)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _batch(B=2, seed=0):
    rng = np.random.default_rng(seed)
    return {"x0": rng.normal(size=(B, 3, 4, 8, 12)).astype(np.float32),
            "cond": rng.normal(size=(B, 3, 4, 8, 12)).astype(np.float32),
            "text": rng.normal(size=(B, 5, 16)).astype(np.float32)}


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.fixture(scope="module")
def jax_model():
    model = jtr.CogVideoXTransformer(J_TINY)
    b = _batch()
    lat = jnp.concatenate([b["x0"], b["cond"]], axis=2)
    params = model.init(jax.random.PRNGKey(0), lat, b["text"],
                        jnp.zeros((2,), jnp.int32))["params"]
    return model, params


def _port_model(params, remat=False):
    m = tr.CogVideoXTransformer(
        tr.TransformerConfig(**{**T_TINY.__dict__, "remat": remat}),
        device="cpu")
    m.load_state_dict(convert.cogvideox_dit_from_numpy(
        _np_tree(params), head_dim=16, device="cpu"))
    return m


def _draws(key, B=2, T=1000, shape=(2, 3, 4, 8, 12)):
    """The t and noise that the JAX step draws from ``key``."""
    rt, rn = jax.random.split(key)
    t = jax.random.randint(rt, (B,), 0, T)
    noise = jax.random.normal(rn, shape, jnp.float32)
    return torch.from_numpy(np.array(t)), torch.from_numpy(np.array(noise))


def _adam_state(opt_state):
    return [s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)][0]


def _close_params(got: dict, want_flax, atol, rtol=1e-4):
    want = convert.cogvideox_dit_from_numpy(_np_tree(want_flax),
                                            head_dim=16, device="cpu")
    assert got.keys() == want.keys()
    for k in want:
        torch.testing.assert_close(got[k].detach(), want[k], atol=atol,
                                   rtol=rtol, msg=k)


# ---- optimizer -------------------------------------------------------------

def test_schedule_matches_optax():
    for cfg in (dit.DiTTrainConfig(lr=1e-4, warmup_steps=10,
                                   total_steps=100),
                dit.DiTTrainConfig(lr=3e-4, warmup_steps=5, total_steps=3)):
        sched = optax.warmup_cosine_decay_schedule(
            0.0, cfg.lr, cfg.warmup_steps,
            max(cfg.total_steps, cfg.warmup_steps + 1))
        for c in (0, 1, 4, 5, 9, 10, 11, 50, 99, 100, 150):
            np.testing.assert_allclose(dit.warmup_cosine_lr(c, cfg),
                                       float(sched(c)), rtol=1e-6,
                                       atol=1e-12)


def test_optimizer_matches_optax_over_five_updates():
    # gradients alternate between below and above the clip norm; f32 on
    # both sides, the same formulas in another association: 1e-6
    cfg = dit.DiTTrainConfig(lr=1e-2, warmup_steps=2, total_steps=6,
                             weight_decay=0.1)
    rng = np.random.default_rng(0)
    params = {"w": rng.normal(size=(3, 4)).astype(np.float32),
              "b": rng.normal(size=(5,)).astype(np.float32)}
    jopt = jdit.make_optimizer(jdit.DiTTrainConfig(
        lr=cfg.lr, warmup_steps=cfg.warmup_steps,
        total_steps=cfg.total_steps, weight_decay=cfg.weight_decay))
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jstate = jopt.init(jp)
    opt = dit.make_optimizer(cfg)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    tstate = opt.init(tp)
    for i in range(5):
        scale = 0.01 if i % 2 else 10.0
        g = {k: (rng.normal(size=v.shape) * scale).astype(np.float32)
             for k, v in params.items()}
        upd, jstate = jopt.update(jax.tree_util.tree_map(jnp.asarray, g),
                                  jstate, jp)
        jp = optax.apply_updates(jp, upd)
        # the update clips the gradients in place: hand it copies
        gn = opt.update_({k: torch.tensor(v) for k, v in g.items()}, tstate,
                         tp)
        np.testing.assert_allclose(float(gn), float(optax.global_norm(g)),
                                   rtol=1e-6)
        for k in params:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       rtol=1e-6, atol=1e-6)
    assert tstate["count"] == 5


# ---- the full fine-tune step ----------------------------------------------

def _jax_steps(model, params, cfg, batch, keys):
    """The JAX state after each step and the metrics of each."""
    init_state, step = jdit.make_dit_train_step(model, cfg)
    jstep = jax.jit(step)
    states, ms = [init_state(params)], []
    for key in keys:
        state, m = jstep(states[-1], batch, key)
        states.append(state)
        ms.append({k: float(v) for k, v in m.items()})
    return states, ms


def _port_steps(params, cfg, batch, keys, remat=False):
    m = _port_model(params, remat)
    init_state, step = dit.make_dit_train_step(m, cfg)
    state = init_state()
    ms = []
    for key in keys:
        t, noise = _draws(key)
        state, met = step(state, _tb(batch), t=t, noise=noise)
        ms.append({k: float(v) for k, v in met.items()})
    return state, ms


@pytest.mark.parametrize("extra", [{}, {"min_snr_gamma": 5.0,
                                        "ema_decay": 0.5}])
def test_dit_train_step_matches_jax(jax_model, extra):
    # two steps from one state with JAX's draws (the second key draws
    # t = [28, 785]; min-SNR-5 weighs t < 61, so one sample). f32; the CPU attention
    # differs in form (JAX: max-subtracted softmax, the port: exp2 without
    # a max) and the sums run in another order: loss and grad_norm 1e-4
    # relative; Adam moves a parameter by about lr = 1e-3, and its
    # direction g / |g| is exact to 1e-4 except where g is near 0, so the
    # updated parameters agree to 5e-6 + 1e-4 relative
    model, params = jax_model
    cfg = dict(TCFG, **extra)
    batch = _batch()
    keys = [jax.random.PRNGKey(1), jax.random.PRNGKey(11),
            jax.random.PRNGKey(7)]
    jstates, jm = _jax_steps(model, params, jdit.DiTTrainConfig(**cfg),
                             jax.tree_util.tree_map(jnp.asarray, batch),
                             keys)
    tstate, tm = _port_steps(params, dit.DiTTrainConfig(**cfg), batch,
                             keys[:2])
    for a, b in zip(tm, jm):
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-4)
        np.testing.assert_allclose(a["grad_norm"], b["grad_norm"],
                                   rtol=1e-4)
    jstate = jstates[2]
    assert tstate["step"] == 2 and tstate["opt"]["count"] == 2
    _close_params(tstate["params"], jstate["params"], atol=5e-6)
    if "ema_decay" in extra:
        _close_params(tstate["ema"], jstate["ema"], atol=5e-6)
    # and from the converted JAX state the third step agrees too
    adam = _adam_state(jstate["opt"])
    conv = convert.dit_train_state_from_numpy(_np_tree({
        "params": jstate["params"], "step": jstate["step"],
        "opt": {"count": adam.count, "mu": adam.mu, "nu": adam.nu},
        **({"ema": jstate["ema"]} if "ema" in jstate else {})}),
        head_dim=16, device="cpu")
    m = _port_model(params)
    init_state, step = dit.make_dit_train_step(m, dit.DiTTrainConfig(**cfg))
    t, noise = _draws(keys[2])
    s3, m3 = step(conv, _tb(batch), t=t, noise=noise)
    np.testing.assert_allclose(float(m3["loss"]), jm[2]["loss"], rtol=1e-4)
    _close_params(s3["params"], jstates[3]["params"], atol=5e-6)


def test_remat_matches_no_remat(jax_model):
    # recomputing blocks in the backward changes no arithmetic on the CPU
    _, params = jax_model
    batch = _batch()
    keys = [jax.random.PRNGKey(3)]
    cfg = dit.DiTTrainConfig(**TCFG)
    a, ma = _port_steps(params, cfg, batch, keys)
    b, mb = _port_steps(params, cfg, batch, keys, remat=True)
    assert ma == mb
    g = {}
    for remat in (False, True):
        m = _port_model(params, remat)
        t, noise = _draws(keys[0])
        loss = dit.diffusion_loss(m, _tb(batch), t, noise,
                                  dit._sched_tables(cfg, "cpu"))
        g[remat] = torch.autograd.grad(loss, list(m.parameters()))
    for x, y in zip(g[False], g[True]):
        torch.testing.assert_close(x, y, atol=1e-7, rtol=1e-6)


def test_fit_steps_over_the_batches(jax_model):
    _, params = jax_model
    m = _port_model(params)
    batches = [_tb(_batch(seed=s)) for s in range(3)]
    state, history = dit.fit(m, batches, dit.DiTTrainConfig(**TCFG),
                             torch.Generator().manual_seed(0), log_every=2)
    assert state["step"] == 3 and state["opt"]["count"] == 3
    assert len(history) == 2
    assert all(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"])
               for h in history)


def test_checkpoint_round_trip_and_resume(jax_model, tmp_path):
    # resume from a saved state reproduces the next step exactly
    _, params = jax_model
    batch = _tb(_batch())
    m = _port_model(params)
    init_state, step = dit.make_dit_train_step(m, dit.DiTTrainConfig(
        **TCFG))
    state = init_state()
    gen = torch.Generator().manual_seed(0)
    for _ in range(3):
        state, _ = step(state, batch, gen)
    checkpoint.save_checkpoint(str(tmp_path), state, 3)
    assert checkpoint.latest_iteration(str(tmp_path)) == 3
    restored, it = checkpoint.restore_checkpoint(str(tmp_path), state)
    assert it == 3 and restored["step"] == 3
    t, noise = _draws(jax.random.PRNGKey(99))
    _, m1 = step(state, batch, t=t, noise=noise)
    p1 = {k: v.detach().clone() for k, v in state["params"].items()}
    _, m2 = step(restored, batch, t=t, noise=noise)
    assert float(m1["loss"]) == float(m2["loss"])
    for k, v in restored["params"].items():
        torch.testing.assert_close(v.detach(), p1[k], atol=0, rtol=0)
    with pytest.raises(FileNotFoundError):
        checkpoint.restore_checkpoint(str(tmp_path / "none"))


# ---- LoRA -------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_lora(jax_model):
    _, params = jax_model
    cfg = jlora.LoRAConfig(rank=4)
    ad = jlora.init_lora(params, cfg, jax.random.PRNGKey(4))
    # nonzero b, so the adapters do something
    return jax.tree_util.tree_map(lambda x: x + 0.02 * jnp.ones_like(x), ad)


def test_lora_sites_and_size_match_jax(jax_model, jax_lora):
    _, params = jax_model
    m = _port_model(params)
    ad = lora.init_lora(m, lora.LoRAConfig(rank=4),
                        torch.Generator().manual_seed(0))
    assert len(ad) == len(jax_lora) == 8
    assert lora.n_params(ad) == jlora.n_params(jax_lora)
    conv = convert.lora_from_numpy(_np_tree(jax_lora), head_dim=16,
                                   device="cpu")
    assert {k: tuple(v["b"].shape) for k, v in conv.items()} == {
        k: tuple(v["b"].shape) for k, v in ad.items()}


def test_lora_identity_at_init(jax_model):
    _, params = jax_model
    m = _port_model(params)
    ad = lora.init_lora(m, lora.LoRAConfig(rank=4),
                        torch.Generator().manual_seed(1))
    lat = torch.from_numpy(np.concatenate([_batch()["x0"],
                                           _batch()["cond"]], 2))
    txt, t = torch.from_numpy(_batch()["text"]), torch.tensor([7, 31])
    with torch.no_grad():
        torch.testing.assert_close(
            lora.lora_apply(m, ad, lora.LoRAConfig(rank=4), lat, txt, t),
            m(lat, txt, t), atol=0, rtol=0)


def test_lora_apply_matches_merged_and_jax(jax_model, jax_lora):
    # merge-free == merged weights (f32, tight), both == the JAX
    # lora_apply to the DiT's 1e-4; export_merged bakes the same model
    model, params = jax_model
    cfg, jcfg = lora.LoRAConfig(rank=4), jlora.LoRAConfig(rank=4)
    m = _port_model(params)
    ad = convert.lora_from_numpy(_np_tree(jax_lora), head_dim=16,
                                 device="cpu")
    b = _batch()
    lat = np.concatenate([b["x0"], b["cond"]], 2)
    t = np.array([100, 500], np.int32)
    want = jlora.lora_apply(model, params, jax_lora, jcfg, jnp.asarray(lat),
                            jnp.asarray(b["text"]), jnp.asarray(t))
    args = (torch.from_numpy(lat), torch.from_numpy(b["text"]),
            torch.from_numpy(t))
    with torch.no_grad():
        free = lora.lora_apply(m, ad, cfg, *args)
        base = m(*args)
        merged_sd = lora.export_merged(m.state_dict(), ad, cfg)
        m2 = _port_model(params)
        m2.load_state_dict(merged_sd)
        merged = m2(*args)
    np.testing.assert_allclose(free.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)
    torch.testing.assert_close(free, merged, atol=1e-5, rtol=1e-5)
    assert float((free - base).abs().max()) > 1e-3
    assert all(v.device.type == "cpu" for v in merged_sd.values())


def test_lora_train_step_matches_jax(jax_model, jax_lora):
    # two LoRA steps from the same adapters with JAX's draws; bounds as in
    # test_dit_train_step_matches_jax
    model, params = jax_model
    cfg = dict(TCFG, weight_decay=0.0)
    jcfg, lcfg = jdit.DiTTrainConfig(**cfg), jlora.LoRAConfig(rank=4)
    batch = _batch()
    init_j, jstep = jlora.make_lora_train_step(model, params, jcfg, lcfg)
    jstate = init_j(jax.random.PRNGKey(1))
    jstate["lora"] = jax_lora
    jstate["opt"] = jdit.make_optimizer(jcfg).init(jax_lora)
    jstep = jax.jit(jstep)
    m = _port_model(params)
    init_t, tstep = lora.make_lora_train_step(m, dit.DiTTrainConfig(**cfg),
                                              lora.LoRAConfig(rank=4))
    tstate = init_t()
    tstate["lora"] = convert.lora_from_numpy(_np_tree(jax_lora),
                                             head_dim=16, device="cpu")
    for key in (jax.random.PRNGKey(2), jax.random.PRNGKey(3)):
        jstate, jm = jstep(jstate, jax.tree_util.tree_map(jnp.asarray, batch),
                           key)
        t, noise = _draws(key)
        tstate, tm = tstep(tstate, _tb(batch), t=t, noise=noise)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-4)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-4)
    want = convert.lora_from_numpy(_np_tree(jstate["lora"]), head_dim=16,
                                   device="cpu")
    moved = 0.0
    for site, ab in want.items():
        for k in ab:
            torch.testing.assert_close(tstate["lora"][site][k], ab[k],
                                       atol=5e-6, rtol=1e-4)
        moved = max(moved, float((ab["b"] - 0.02).abs().max()))
    assert moved > 1e-4
    # the base weights are frozen and untouched
    assert not any(p.requires_grad for p in m.parameters())


def test_full_scale_adapter_count_on_meta():
    m = tr.CogVideoXTransformer(tr.TransformerConfig(), device="meta")
    ad = lora.init_lora(m, lora.LoRAConfig(rank=16))
    assert len(ad) == 42 * 4
    assert lora.n_params(ad) == 33_030_144 == 42 * 786_432


# ---- data, encoders, CLI ----------------------------------------------------

def _frame_dirs(root, n_videos=2, n_frames=12, hw=(16, 24)):
    from PIL import Image
    rng = np.random.default_rng(0)
    for v in range(n_videos):
        d = os.path.join(root, f"vid{v}")
        os.makedirs(d)
        for f in range(n_frames):
            Image.fromarray(rng.integers(0, 255, hw + (3,), np.uint8)).save(
                os.path.join(d, f"{f:04d}.png"))
    return sorted(os.path.join(root, f"vid{v}") for v in range(n_videos))


def test_datasets_match_jax(tmp_path):
    roots = _frame_dirs(str(tmp_path))
    assert datasets.valid_clip_length(12) == jds.valid_clip_length(12) == 9
    ccfg = dict(num_frames=5, stride=2, size_hw=(8, 12))
    a = datasets.VideoClipDataset(roots, datasets.ClipSamplerConfig(**ccfg),
                                  seed=3)
    b = jds.VideoClipDataset(roots, jds.ClipSamplerConfig(**ccfg), seed=3)
    assert len(a) == len(b) == 2
    for _ in range(3):
        for x, y in zip(a.sample(), b.sample()):
            np.testing.assert_array_equal(x, y)
    ae, je = (mod.AutoEncoderDataset(roots, num_frames=6, size_hw=(8, 12))
              for mod in (datasets, jds))
    np.testing.assert_array_equal(ae.sample(), je.sample())
    ims, jims = (mod.ImageFolderDataset(roots[0], size_hw=(8, 12), seed=1)
                 for mod in (datasets, jds))
    np.testing.assert_array_equal(ims.sample(), jims.sample())


def test_encoders_and_build_batch_match_jax(tmp_path):
    roots = _frame_dirs(str(tmp_path), n_frames=20, hw=(64, 96))
    clip = np.random.default_rng(1).uniform(-1, 1, (9, 3, 64, 96)).astype(
        np.float32)
    np.testing.assert_array_equal(finetune.stub_encode(clip),
                                  jft.stub_encode(clip))
    # the real-VAE encode_fn is the posterior mean of the port's VAE
    # (held against the JAX VAE in test_torch_cogvideox.py) times the
    # scale; load_vae_encode reads the same weights from a checkpoint dict
    torch.manual_seed(0)
    tv = vae.AutoencoderKL3D(finetune.TINY_VAE, device="cpu")
    sd = tv.state_dict()
    enc = finetune.make_vae_encode(sd, finetune.TINY_VAE, scale=0.7,
                                   device="cpu")
    small = clip[:5, :, :16, :24]
    with torch.no_grad():
        mean, _ = tv.encode(torch.from_numpy(small[None]))
    got = enc(small)
    assert got.shape == (2, 16, 2, 3)
    np.testing.assert_allclose(got, (mean * 0.7)[0].numpy(), atol=1e-6,
                               rtol=1e-6)
    path = os.path.join(str(tmp_path), "ckpt.pt")
    torch.save({"vae": sd}, path)
    enc2 = finetune.load_vae_encode(path, finetune.TINY_VAE, device="cpu")
    np.testing.assert_array_equal(enc2(small), got)
    # build_batch over the same dataset state and text stub
    ccfg = dict(num_frames=9, size_hw=(64, 96))
    ds = datasets.VideoClipDataset(roots, datasets.ClipSamplerConfig(**ccfg))
    jds_ = jds.VideoClipDataset(roots, jds.ClipSamplerConfig(**ccfg))
    text = TextEncoder(embed_dim=64)
    with pytest.warns(RuntimeWarning):
        got = finetune.build_batch(ds, text, 2, "a cat", finetune.stub_encode,
                                   device="cpu")
        want = jft.build_batch(jds_, text, 2, "a cat", jft.stub_encode)
    for k in ("x0", "cond", "text"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    assert got["x0"].shape == (2, 3, 16, 8, 12)


@pytest.mark.parametrize("mode", [[], ["--lora", "--rank", "4"]])
def test_finetune_cli_tiny_runs_and_saves(tmp_path, mode):
    data = tmp_path / "data"
    data.mkdir()
    _frame_dirs(str(data), n_videos=1, n_frames=17, hw=(64, 96))
    out = tmp_path / "out"
    with pytest.warns(RuntimeWarning):
        last = finetune.main(["--data", str(data), "--tiny", "--device",
                              "cpu", "--steps", "2", "--log-every", "1",
                              "--save-every", "1", "--out", str(out),
                              *mode])
    assert np.isfinite(last["loss"]) and np.isfinite(last["grad_norm"])
    assert checkpoint.latest_iteration(str(out)) == 2
    state, _ = checkpoint.restore_checkpoint(str(out))
    assert state["step"] == 2 and ("lora" in state) == bool(mode)


def test_finetune_cli_tiny_refuses_the_card(tmp_path, monkeypatch):
    _frame_dirs(str(tmp_path), n_videos=1, n_frames=17, hw=(64, 96))
    with pytest.raises(ValueError, match="CPU only"):
        finetune.main(["--data", str(tmp_path), "--tiny", "--device",
                       "cuda"])
    with pytest.raises(FileNotFoundError, match="config.json"):
        finetune.main(["--data", str(tmp_path), "--tiny", "--device", "cpu",
                       "--t5", "/nonexistent"])
    # without --device the default is the card; where there is none, an
    # error, never the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        finetune.main(["--data", str(tmp_path), "--tiny"])
