"""The VAE fine-tune of the PyTorch port vs the JAX package on the CPU, in
f32: the losses (KL, the NLL with and without LPIPS, LeCam, hinge and
vanilla GAN losses, R1, the adaptive weight), LPIPS at VGG16's full
width through ``lpips_from_numpy``, ``Discriminator3D`` on odd and even
H and W through ``discriminator_from_numpy`` (XLA's 'SAME' pads), the
VAE's sampling forward with JAX's noise, two trainer steps (with LPIPS)
from one state carried across by ``vae_train_state_from_numpy``, on both
sides of ``disc_start_step`` with JAX's own noise, and ``PRESETS``.

Tolerances: the losses 1e-6 relative (the same float32 formulas); LPIPS
and D 1e-4 absolute + 1e-4 relative (float32 convolutions summed in
another order); the trainer's losses 1e-4 relative, the
LeCam EMAs 1e-6 absolute, ``logvar`` (minus lr times a sum over every
pixel, about 3 after one step) 1e-5 relative. After a step, Adam moves a parameter by about
lr = 1e-3 in the direction g / (|g| + eps), exact to 1e-4 except where g
is near 0, so the parameters agree to 5e-6 absolute + 1e-4 relative."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_threads import few_torch_threads  # noqa: F401

from langscenex_tpu.models import lpips as jlpips
from langscenex_tpu.models.cogvideox import losses as jlosses
from langscenex_tpu.models.cogvideox import vae as jvae
from langscenex_tpu.train import vae as jtrain
from langscenex_tpu.utils import presets as jpresets
from langscenex_tpu_torch import convert
from langscenex_tpu_torch.models import lpips
from langscenex_tpu_torch.models.cogvideox import losses, vae
from langscenex_tpu_torch.train import vae as train
from langscenex_tpu_torch.utils import presets

VAE_KW = dict(block_out_channels=(4, 8, 8, 8), layers_per_block=1,
              latent_channels=2, norm_groups=2)
SHAPE = (1, 5, 3, 16, 16)
LR = 1e-3


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def _rng_arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32) for s in shapes]


# ---------------------------------------------------------------- losses

def test_losses_match_jax():
    d_real, d_fake = _rng_arrays(0, (2, 3, 4, 4), (2, 3, 4, 4))
    mean, logvar = _rng_arrays(1, (2, 2, 2, 3, 3), (2, 2, 2, 3, 3))
    recon, target = _rng_arrays(2, (2, 5, 3, 8, 8), (2, 5, 3, 8, 8))
    out_logvar = np.float32(0.3)
    ema = (np.float32(0.2), np.float32(-0.4))
    close = dict(rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(
        float(losses.kl_divergence(_t(mean), _t(logvar))),
        float(jlosses.kl_divergence(mean, logvar)), **close)
    pw = lambda a, b: jnp.mean(jnp.abs(a - b), axis=(2, 3, 4),  # noqa: E731
                               keepdims=True)
    tw = lambda a, b: (a - b).abs().mean((2, 3, 4), keepdim=True)  # noqa
    for jf, tf in ((None, None), (pw, tw)):
        jt, jp = jlosses.vae_loss(recon, target, mean, logvar, out_logvar,
                                  lpips_fn=jf)
        tt, tp = losses.vae_loss(_t(recon), _t(target), _t(mean),
                                 _t(logvar), _t(out_logvar), lpips_fn=tf)
        np.testing.assert_allclose(float(tt), float(jt), **close)
        for k in ("nll", "kl"):
            np.testing.assert_allclose(float(tp[k]), float(jp[k]), **close)
    jema = jlosses.LeCamEMA(*map(jnp.asarray, ema))
    tema = losses.LeCamEMA(*map(_t, ema))
    np.testing.assert_allclose(
        float(losses.lecam_reg(_t(d_real), _t(d_fake), tema)),
        float(jlosses.lecam_reg(d_real, d_fake, jema)), **close)
    nj, nt = jema.update(d_real, d_fake), tema.update(_t(d_real),
                                                      _t(d_fake))
    np.testing.assert_allclose([float(nt.real), float(nt.fake)],
                               [float(nj.real), float(nj.fake)], **close)
    for kind in ("hinge", "vanilla"):
        np.testing.assert_allclose(
            float(losses.discriminator_loss(_t(d_real), _t(d_fake), kind)),
            float(jlosses.discriminator_loss(d_real, d_fake, kind)), **close)
        np.testing.assert_allclose(
            float(losses.generator_loss(_t(d_fake), kind)),
            float(jlosses.generator_loss(d_fake, kind)), **close)
    for a, b in ((0.5, 2.0), (3e5, 1e-3), (0.0, 1.0)):
        np.testing.assert_allclose(
            float(losses.adaptive_generator_weight(_t(np.float32(a)),
                                                   _t(np.float32(b)))),
            float(jlosses.adaptive_generator_weight(a, b)), **close)


@pytest.fixture(scope="module")
def disc_pair():
    jd = jtrain.Discriminator3D(base=4)
    params = jax.jit(jd.init)(jax.random.PRNGKey(3),
                              jnp.zeros((1, 3, 3, 16, 16)))
    td = train.Discriminator3D(base=4, device="cpu")
    td.load_state_dict(convert.discriminator_from_numpy(_np(params), "cpu"),
                       strict=True)
    return jd, params, td


@pytest.mark.parametrize("hw", [(16, 16), (15, 17), (9, 12), (13, 13)])
def test_discriminator_matches_jax_on_odd_and_even_sizes(disc_pair, hw):
    jd, params, td = disc_pair
    x, = _rng_arrays(4, (2, 3, 3) + hw)
    want = jax.jit(jd.apply)(params, x)
    with torch.no_grad():
        got = td(_t(x))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)


def test_r1_penalty_matches_jax(disc_pair):
    jd, params, td = disc_pair
    x, = _rng_arrays(5, (2, 3, 3, 9, 12))
    want = jlosses.r1_gradient_penalty(lambda v: jd.apply(params, v),
                                       jnp.asarray(x))
    got = losses.r1_gradient_penalty(td, _t(x))
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-4)
    # the penalty keeps its graph: it can be differentiated w.r.t. D
    g = torch.autograd.grad(got, td.head.weight)[0]
    assert torch.isfinite(g).all() and g.abs().sum() > 0


@pytest.fixture(scope="module")
def lpips_pair():
    jm = jlpips.LPIPS()
    params = jax.jit(jm.init)(jax.random.PRNGKey(4),
                              jnp.zeros((1, 3, 16, 16)),
                              jnp.zeros((1, 3, 16, 16)))
    tm = lpips.LPIPS(device="cpu").eval()
    tm.load_state_dict(convert.lpips_from_numpy(_np(params), "cpu"),
                       strict=True)
    return jm, params, tm


def test_lpips_matches_jax(lpips_pair):
    jm, params, tm = lpips_pair
    a, b = _rng_arrays(6, (2, 3, 32, 32), (2, 3, 32, 32))
    a, b = np.tanh(a), np.tanh(b)
    want = jax.jit(jm.apply)(params, a, b)
    with torch.no_grad():
        got = tm(_t(a), _t(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)
    # taming's keys: the slices keep torchvision's feature indices
    keys = tm.state_dict().keys()
    assert {"net.slice1.0.weight", "net.slice5.28.bias",
            "lin4.model.1.weight", "scaling_layer.shift"} <= keys


# --------------------------------------------------------------- trainer

def _jax_lpips_fn(jm, params):
    def fn(recon, target):
        B, T = recon.shape[:2]
        d = jm.apply(params, recon.reshape((B * T,) + recon.shape[2:]),
                     target.reshape((B * T,) + target.shape[2:]))
        return d.reshape(B, T, 1, 1, 1)
    return fn


def _state_dict(s):
    """A JAX VAETrainState as the numpy dict of the port's converter."""
    def adam(o):
        return {"count": o[0].count, "mu": o[0].mu, "nu": o[0].nu}
    return _np({"vae_params": s.vae_params, "disc_params": s.disc_params,
                "vae_opt": adam(s.vae_opt), "disc_opt": adam(s.disc_opt),
                "logvar": s.logvar, "lecam": {"real": s.lecam.real,
                                              "fake": s.lecam.fake},
                "step": s.step})


def _close_state(got, want):
    for a, b in ((got.vae_params, want.vae_params),
                 (got.disc_params, want.disc_params)):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_allclose(a[k].numpy(), b[k].numpy(),
                                       atol=5e-6, rtol=1e-4, err_msg=k)
    np.testing.assert_allclose(float(got.logvar), float(want.logvar),
                               rtol=1e-5)
    np.testing.assert_allclose([float(got.lecam.real), float(got.lecam.fake)],
                               [float(want.lecam.real),
                                float(want.lecam.fake)], atol=1e-6)
    assert got.step == want.step
    assert got.vae_opt.count == want.vae_opt.count


class _JitInitVAE(jvae.AutoencoderKL3D):
    """The JAX VAE with its ``init`` traced (flax's eager init of the tiny
    VAE takes most of a minute; the traced one a few seconds)."""

    def init(self, *args, **kwargs):
        return jax.jit(super().init)(*args, **kwargs)


CFG_KW = dict(lr=LR, disc_lr=LR, disc_start_step=1, kl_weight=1e-3)


@pytest.fixture(scope="module")
def jax_trainer(lpips_pair):
    """The JAX trainer (with the per-frame LPIPS) and its initial state as
    the port's converter reads it."""
    jl, lp_params, _ = lpips_pair
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtrain, "AutoencoderKL3D", _JitInitVAE)
        jtr = jtrain.VAETrainer(jvae.VAEConfig(**VAE_KW),
                                jtrain.VAETrainConfig(**CFG_KW),
                                sample_shape=SHAPE,
                                lpips_fn=_jax_lpips_fn(jl, lp_params))
    return jtr, _state_dict(jtr.state)


def test_vae_forward_with_jax_noise(jax_trainer):
    jtr, state0 = jax_trainer
    x, = _rng_arrays(7, SHAPE)
    key = jax.random.PRNGKey(5)
    recon, mean, logvar = jax.jit(jtr.vae.apply)(state0["vae_params"], x,
                                                 key)
    eps = jax.random.normal(key, mean.shape)
    tm = vae.AutoencoderKL3D(vae.VAEConfig(**VAE_KW), device="cpu")
    tm.load_state_dict(convert.cogvideox_vae_from_numpy(
        state0["vae_params"], "cpu"))
    with torch.no_grad():
        got = tm(_t(x), eps=_t(eps))
        plain = tm(_t(x))
    for g, w in zip(got, (recon, mean, logvar)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-4,
                                   rtol=1e-3)
    assert not torch.allclose(plain[0], got[0])


def test_two_trainer_steps_match_jax(lpips_pair, jax_trainer):
    """Step 0 before ``disc_start_step`` (D's parameters stay, its Adam
    advances, no adversarial term), step 1 after it, with JAX's noise,
    from the JAX trainer's initial state carried across."""
    _, _, tl = lpips_pair
    jtr, state0 = jax_trainer
    ttr = train.VAETrainer(vae.VAEConfig(**VAE_KW),
                           train.VAETrainConfig(**CFG_KW),
                           lpips_fn=lpips.per_frame(tl), device="cpu")
    ttr.state = convert.vae_train_state_from_numpy(state0, device="cpu")
    x, = _rng_arrays(8, SHAPE)
    x = np.tanh(x)
    lat = (1, 2, 2, 2, 2)
    d0 = ttr.state.disc_params
    for i, seed in enumerate((1, 2)):
        key = jax.random.PRNGKey(seed)
        eps = np.asarray(jax.random.normal(key, lat))
        jm = jtr.train_step(x, key)
        tm = ttr.train_step(x, eps=eps)
        assert tm.keys() == jm.keys()
        for k in jm:
            np.testing.assert_allclose(tm[k], jm[k], rtol=1e-4, atol=1e-6,
                                       err_msg=k)
        _close_state(ttr.state, convert.vae_train_state_from_numpy(
            _state_dict(jtr.state), device="cpu"))
        same_d = all(torch.equal(ttr.state.disc_params[k], d0[k])
                     for k in d0)
        assert same_d == (i == 0)
    assert ttr.state.disc_opt.count == 2
    assert float(ttr.state.logvar) != 0.0


def _same_config(got, want, where):
    """Every field the two configs share agrees (nested configs too)."""
    fields = ({f.name for f in dataclasses.fields(want)}
              & {f.name for f in dataclasses.fields(got)})
    assert fields, where
    for f in fields - {"dtype", "attn_dtype"}:
        g, w = getattr(got, f), getattr(want, f)
        if dataclasses.is_dataclass(w):
            _same_config(g, w, (where, f))
        elif isinstance(w, (tuple, list)):
            assert tuple(g) == tuple(w), (where, f)
        else:
            assert g == w, (where, f)


def test_presets_match_jax():
    # the port's TransformerConfig has no timestep_activation_fn or
    # fuse_qkv (its DiT has one activation and separate q/k/v): every
    # field the two configs share must agree
    assert presets.PRESETS.keys() == jpresets.PRESETS.keys()
    for name, fn in presets.PRESETS.items():
        _same_config(fn(), jpresets.PRESETS[name](), name)
