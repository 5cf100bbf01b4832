"""The TriMap video-diffusion slice of the PyTorch port vs the JAX package
on the CPU, in f32: the DiT carried over from JAX-initialised params by
``cogvideox_dit_from_numpy`` (and the weight round trip through the JAX
converter), the schedulers, the CFG denoise loop with and without the
output broadcast, the VAE and its tiled decode, the text stub, and the
tiny ``build_pipeline`` end to end with the same weights and noise."""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_threads import few_torch_threads  # noqa: F401

from langscenex_tpu import video_inference as jvi
from langscenex_tpu.models import t5 as jt5
from langscenex_tpu.models.cogvideox import pipeline as jpipe
from langscenex_tpu.models.cogvideox import scheduler as jsched
from langscenex_tpu.models.cogvideox import transformer as jtr
from langscenex_tpu.models.cogvideox import vae as jvae
from langscenex_tpu.utils.convert import (convert_cogvideox_dit,
                                          convert_cogvideox_vae)
from langscenex_tpu_torch import _build, convert, video_inference
from langscenex_tpu_torch.models import t5
from langscenex_tpu_torch.models.cogvideox import pipeline, scheduler, vae
from langscenex_tpu_torch.models.cogvideox import transformer as tr

# tests/test_cogvideox.py's TINY DiT and tests/test_vae.py's TINY VAE
J_TINY = jtr.TransformerConfig(num_layers=2, num_heads=4, head_dim=16,
                               in_channels=8, out_channels=4, patch_size=2,
                               text_embed_dim=16, time_embed_dim=32,
                               attn_dtype=jnp.float32)
T_TINY = tr.TransformerConfig(num_layers=2, num_heads=4, head_dim=16,
                              in_channels=8, out_channels=4, patch_size=2,
                              text_embed_dim=16, time_embed_dim=32,
                              attn_dtype=torch.float32)
J_VAE = jvae.VAEConfig(block_out_channels=(8, 16, 16, 32), layers_per_block=1,
                       latent_channels=4, norm_groups=4)
T_VAE = vae.VAEConfig(block_out_channels=(8, 16, 16, 32), layers_per_block=1,
                      latent_channels=4, norm_groups=4)
PCFG = dict(num_frames=9, height=16, width=24, latent_channels=4,
            vae_scale_factor_spatial=2, vae_scale_factor_temporal=4,
            vae_scaling_factor=1.0)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def dit_pair():
    """The JAX TINY DiT with its params, and the port's model loaded from
    them."""
    model = jtr.CogVideoXTransformer(J_TINY)
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 3, 8, 8, 12)),
                        jnp.zeros((1, 5, 16)), jnp.zeros((1,), jnp.int32))
    tmodel = tr.CogVideoXTransformer(T_TINY, device="cpu").eval()
    tmodel.load_state_dict(convert.cogvideox_dit_from_numpy(
        _np_tree(params), head_dim=16, device="cpu"))
    return model, params, tmodel


def _inputs(seed, B=2):
    rng = np.random.default_rng(seed)
    lat = rng.normal(size=(B, 3, 8, 8, 12)).astype(np.float32)
    txt = rng.normal(size=(B, 5, 16)).astype(np.float32)
    return lat, txt


def test_dit_matches_jax(dit_pair):
    # f32; JAX's CPU attention is a max-subtracted softmax, the port's the
    # kernel's exp2 form without a max, and the sums run in another order
    # over 2 blocks: 1e-4
    model, params, tmodel = dit_pair
    lat, txt = _inputs(0)
    t = np.array([10, 700], np.int32)
    want = model.apply(params, jnp.asarray(lat), jnp.asarray(txt),
                       jnp.asarray(t))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(lat), torch.from_numpy(txt),
                     torch.from_numpy(t))
    assert got.shape == (2, 3, 4, 8, 12)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)


def test_dit_plain_switch_is_the_same_model(dit_pair):
    # on CPU tensors the kernel wrappers run the plain versions, so
    # _build.plain() must not change a bit
    _, _, tmodel = dit_pair
    lat, txt = map(torch.from_numpy, _inputs(1))
    t = torch.tensor([250, 250])
    with torch.no_grad():
        a = tmodel(lat, txt, t)
        with _build.plain():
            b = tmodel(lat, txt, t)
    torch.testing.assert_close(a, b, atol=0, rtol=0)


def test_dit_weights_round_trip_through_jax_converter(dit_pair):
    # port state_dict (diffusers keys) -> the JAX package's converter ->
    # the original flax params, bit for bit
    _, params, tmodel = dit_pair
    sd = {k: v.numpy() for k, v in tmodel.state_dict().items()}
    back = convert_cogvideox_dit(sd, fuse_qkv=True, head_dim=16)
    want = {jax.tree_util.keystr(p): np.asarray(v) for p, v in
            jax.tree_util.tree_leaves_with_path(params)}
    got = {jax.tree_util.keystr(p): np.asarray(v) for p, v in
           jax.tree_util.tree_leaves_with_path(back)}
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_rope_and_timestep_tables_match_jax():
    cos, sin = jtr.rope_3d(J_TINY, 3, 4, 6)
    tcos, tsin = tr.rope_3d(T_TINY, 3, 4, 6)
    np.testing.assert_allclose(tcos.numpy(), np.asarray(cos), atol=1e-6)
    np.testing.assert_allclose(tsin.numpy(), np.asarray(sin), atol=1e-6)
    cf, sf = jtr.rope_full_tables(cos, sin, text_len=5)
    tcf, tsf = tr.rope_full_tables(tcos, tsin, text_len=5)
    np.testing.assert_allclose(tcf.numpy(), np.asarray(cf), atol=1e-6)
    np.testing.assert_allclose(tsf.numpy(), np.asarray(sf), atol=1e-6)
    x = np.random.default_rng(2).normal(size=(2, 77, 4, 16)).astype(
        np.float32)
    want = jtr.apply_rope_fused(jnp.asarray(x), cf[:, None], sf[:, None])
    got = tr.apply_rope_fused(torch.from_numpy(x), tcf[:, None], tsf[:, None])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    # the fused rotation is the interleaved one on the video rows
    np.testing.assert_allclose(
        got[:, 5:].numpy(), tr.apply_rope(torch.from_numpy(x[:, 5:]).transpose(
            1, 2), tcos, tsin).transpose(1, 2).numpy(), atol=1e-6)
    ts = np.array([0.0, 17.0, 999.0], np.float32)
    np.testing.assert_allclose(
        tr.sinusoidal_timestep(torch.from_numpy(ts), 64).numpy(),
        np.asarray(jtr.sinusoidal_timestep(jnp.asarray(ts), 64)), atol=1e-5)


@pytest.mark.parametrize("n", [2, 7, 50])
def test_scheduler_tables_match_jax(n):
    js, ts = jsched.DDIMScheduler(), scheduler.DDIMScheduler()
    assert ts.timesteps(n) == np.asarray(js.timesteps(n)).tolist()
    np.testing.assert_array_equal(ts.alphas_cumprod.numpy(),
                                  np.asarray(js.alphas_cumprod))
    cfg = pipeline.PipelineConfig(num_inference_steps=n, broadcast_interval=2)
    jcfg = jpipe.PipelineConfig(num_inference_steps=n, broadcast_interval=2)
    got = pipeline.schedule_arrays(ts, cfg)
    want = jpipe.schedule_arrays(js, jcfg)
    for a, b in zip(got, want):
        assert list(a) == np.asarray(b).tolist()


def test_scheduler_steps_match_jax():
    # f32 elementwise updates with the same alphas: 1e-6
    rng = np.random.default_rng(3)
    x, out = (rng.normal(size=(2, 3, 4, 4)).astype(np.float32)
              for _ in range(2))
    for cls in ("DDIMScheduler", "DPMSolverScheduler"):
        js, ts = getattr(jsched, cls)(), getattr(scheduler, cls)()
        for t, tp in ((999, 499), (499, -1)):
            want = js.step(jnp.asarray(out), t, tp, jnp.asarray(x))
            got = ts.step(torch.from_numpy(out), t, tp, torch.from_numpy(x))
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=1e-6, rtol=1e-6)
    t = np.array([100, 700])
    for fn in ("add_noise", "get_velocity"):
        want = getattr(js, fn)(jnp.asarray(x), jnp.asarray(out),
                               jnp.asarray(t))
        got = getattr(ts, fn)(torch.from_numpy(x), torch.from_numpy(out),
                              torch.from_numpy(t))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    # DPM-Solver++(2M) over a 5-step schedule, first- then second-order
    js, ts = jsched.DPMSolverScheduler(), scheduler.DPMSolverScheduler()
    steps = ts.timesteps(5)
    jstate, tstate = js.init_state(x.shape), ts.init_state(x.shape)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    for i, t in enumerate(steps):
        mo = rng.normal(size=x.shape).astype(np.float32)
        tp = steps[i + 1] if i + 1 < len(steps) else -1
        jx, jstate = js.step_dpm(jstate, jnp.asarray(mo), t, tp, -1, jx)
        tx, tstate = ts.step_dpm(tstate, torch.from_numpy(mo), t, tp, -1, tx)
        np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=1e-5,
                                   rtol=1e-5)


@pytest.mark.parametrize("interval", [1, 2])
def test_denoise_loop_matches_jax(dit_pair, interval):
    # the 4-step CFG loop (broadcast_interval 2 with the window (0.2, 0.9)
    # reuses the prediction at step 1) on the same noise, image latents
    # and text; the TINY DiT in f32 on both sides: 2e-4
    model, params, tmodel = dit_pair
    cfg = dict(PCFG, num_inference_steps=4, broadcast_interval=interval)
    rng = np.random.default_rng(4)
    noise, img = (rng.normal(size=(1, 3, 4, 8, 12)).astype(np.float32)
                  for _ in range(2))
    tc = rng.normal(size=(1, 5, 16)).astype(np.float32)
    tu = np.zeros((1, 5, 16), np.float32)
    want = jpipe.denoise_loop(
        lambda x, txt, t: model.apply(params, x, txt, t),
        *map(jnp.asarray, (noise, img, tc, tu)), jsched.DDIMScheduler(),
        jpipe.PipelineConfig(**cfg))
    evals = []
    with torch.no_grad():
        got = pipeline.denoise_loop(
            tmodel, *map(torch.from_numpy, (noise, img, tc, tu)),
            scheduler.DDIMScheduler(), pipeline.PipelineConfig(**cfg),
            callback=lambda i, t, ev, lat: evals.append(ev))
    assert evals == ([True] * 4 if interval == 1
                     else [True, False, True, True])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4,
                               rtol=2e-4)


@pytest.fixture(scope="module")
def vae_pair():
    model = jvae.AutoencoderKL3D(J_VAE)
    params = jax.jit(model.init)(jax.random.PRNGKey(0),
                                 jnp.zeros((1, 1, 3, 16, 16)))
    tmodel = vae.AutoencoderKL3D(T_VAE, device="cpu").eval()
    tmodel.load_state_dict(convert.cogvideox_vae_from_numpy(
        _np_tree(params), device="cpu"))
    return model, params, tmodel


def test_vae_encode_decode_match_jax(vae_pair):
    # f32 convolutions and GroupNorms summed in another order: the JAX
    # VAE test's mirror bounds (encode 2e-4 + 1e-3 rel, decode 5e-4)
    model, params, tmodel = vae_pair
    video = np.random.default_rng(5).uniform(-1, 1, (1, 5, 3, 32, 32)
                                             ).astype(np.float32)
    jm, jl = model.apply(params, jnp.asarray(video),
                         method=jvae.AutoencoderKL3D.encode)
    with torch.no_grad():
        tm, tl = tmodel.encode(torch.from_numpy(video))
        tdec = tmodel.decode(tm)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), atol=2e-4,
                               rtol=1e-3)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=2e-4,
                               rtol=1e-3)
    jdec = model.apply(params, jm, method=jvae.AutoencoderKL3D.decode)
    assert tdec.shape == jdec.shape == (1, 8, 3, 32, 32)
    np.testing.assert_allclose(tdec.numpy(), np.asarray(jdec), atol=5e-4,
                               rtol=1e-3)


def test_vae_tiled_decode_matches_jax(vae_pair):
    # the same tiles and seam weights around the same decoder: 5e-4
    model, params, tmodel = vae_pair
    z = np.random.default_rng(6).normal(size=(1, 2, 4, 10, 14)).astype(
        np.float32)
    want = jvae.spatial_tile_decode(
        lambda zz: model.apply(params, zz, method=jvae.AutoencoderKL3D.decode),
        jnp.asarray(z), tile=6, overlap=2)
    with torch.no_grad():
        got = vae.spatial_tile_decode(tmodel.decode, torch.from_numpy(z),
                                      tile=6, overlap=2)
    assert got.shape == want.shape == (1, 8, 3, 80, 112)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-4,
                               rtol=1e-3)
    for n, ramp in ((48, 16), (80, 16), (16, 16)):
        np.testing.assert_allclose(vae._blend_profile(n, ramp).numpy(),
                                   np.asarray(jvae._blend_profile(n, ramp)),
                                   atol=1e-7)


def test_vae_weights_round_trip_and_diffusers_keys(vae_pair):
    # the port's VAE keys are the diffusers layout of the JAX package's
    # torch mirror, and they go back through the JAX converter bit for bit
    from torch_cvx_vae_mirror import VAEMirror
    _, params, tmodel = vae_pair
    mirror = VAEMirror({"in_ch": 3, "out_ch": 3, "latent": 4,
                        "block_out": (8, 16, 16, 32), "layers": 1,
                        "groups": 4, "t_levels": 2})
    assert {k: tuple(v.shape) for k, v in mirror.state_dict().items()} == \
        {k: tuple(v.shape) for k, v in tmodel.state_dict().items()}
    back = convert_cogvideox_vae({k: v.numpy() for k, v in
                                  tmodel.state_dict().items()})
    for p, v in jax.tree_util.tree_leaves_with_path(params):
        got = back
        for k in p:
            got = got[k.key]
        np.testing.assert_array_equal(got, np.asarray(v))


def test_text_stub_matches_jax():
    prompts = ["A cat walks on the grass", ""]
    with pytest.warns(RuntimeWarning, match="STUB"):
        got = t5.TextEncoder(embed_dim=32).encode(prompts)
    with pytest.warns(RuntimeWarning, match="STUB"):
        want = jt5.TextEncoder(embed_dim=32).encode(prompts)
    np.testing.assert_array_equal(got, want)
    assert got.shape == (2, 226, 32) and not got[1].any()
    # a checkpoint path loads the T5 encoder (tests/test_torch_t5.py);
    # a missing one is an error, never the stub
    with pytest.raises(FileNotFoundError, match="config.json"):
        t5.TextEncoder("/no/such/t5", device="cpu")


def test_tiny_pipeline_matches_jax(tmp_path):
    # build_pipeline(tiny=True) on both sides with the JAX pipeline's
    # weights (PRNGKey(42), carried over as a --checkpoint file) and the
    # noise the JAX pipeline draws from PRNGKey(1): 4 DDIM steps and the
    # VAE decode, f32: 1e-3
    jpipe_, jtext, jcfg, aux = jvi.build_pipeline(None, None, tiny=True)
    vparams = jax.jit(jvae.AutoencoderKL3D(jvi_tiny_vae()).init)(
        jax.random.PRNGKey(42), jnp.zeros((1, 1, 3, 64, 96)))
    ckpt = tmp_path / "tiny.pt"
    torch.save({"transformer": convert.cogvideox_dit_from_numpy(
        _np_tree(aux["dit_params"]), head_dim=16, device="cpu"),
        "vae": convert.cogvideox_vae_from_numpy(_np_tree(vparams),
                                                device="cpu")}, ckpt)
    pipe, text, cfg, _ = video_inference.build_pipeline(
        str(ckpt), tiny=True, device="cpu")
    assert dataclasses.asdict(cfg) == {
        k: v for k, v in dataclasses.asdict(jcfg).items()
        if k != "loop_chunk"}
    rng = np.random.default_rng(7)
    first, last = (rng.uniform(-1, 1, (1, 3, 64, 96)).astype(np.float32)
                   for _ in range(2))
    with pytest.warns(RuntimeWarning):
        tc, tu = text.encode(["a red chair"]), text.encode([""])
    key = jax.random.PRNGKey(1)
    noise = np.asarray(jax.random.normal(
        key, (1, cfg.latent_frames, cfg.latent_channels, cfg.latent_height,
              cfg.latent_width), jnp.float32))
    want = jpipe_(key, *map(jnp.asarray, (first, last, tc, tu)))
    got = pipe(*map(torch.from_numpy, (first, last, tc, tu)),
               noise=torch.from_numpy(noise.copy()))
    assert got.shape == want.shape == (1, 9, 3, 64, 96)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3,
                               rtol=1e-3)


def jvi_tiny_vae():
    """The VAE config of the JAX ``build_pipeline(tiny=True)``."""
    return jvae.VAEConfig(block_out_channels=(8, 16, 16, 32),
                          layers_per_block=1, latent_channels=4,
                          norm_groups=4)


@pytest.mark.parametrize("entry", [
    lambda: video_inference.build_pipeline(tiny=True),
    lambda: tr.CogVideoXTransformer(T_TINY),
    lambda: vae.AutoencoderKL3D(T_VAE),
    lambda: convert.cogvideox_vae_from_numpy({}),
    lambda: convert.raster_camera_from_numpy(np.eye(4), np.eye(4), 8, 8, 1.0,
                                             1.0)])
def test_entry_points_default_to_the_gpu(entry):
    # no silent CPU fallback: without a card the default device raises
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default resolves to it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry()


@pytest.mark.parametrize("device", ["cuda", "cuda:1"])
def test_tiny_refuses_a_gpu_device(device):
    # the tiny model's head dim 16 and f32 attention are outside what K5
    # and K8 take: it says so up front instead of failing in the first block
    with pytest.raises(ValueError, match="CPU only"):
        video_inference.build_pipeline(tiny=True, device=device)


def test_cli_tiny_end_to_end(tmp_path, capsys):
    # python -m langscenex_tpu_torch.video_inference --tiny on the CPU:
    # keyframes read from PNG files, 9 frames written, the --report line
    from PIL import Image
    rng = np.random.default_rng(8)
    for name in ("a.png", "b.png"):
        Image.fromarray(rng.uniform(0, 255, (64, 96, 3)).astype(np.uint8)
                        ).save(tmp_path / name)
    out = tmp_path / "out"
    with pytest.warns(RuntimeWarning, match="STUB"):
        rc = video_inference.main([
            "--first_image", str(tmp_path / "a.png"),
            "--last_image", str(tmp_path / "b.png"), "--prompt",
            "a test scene", "--output_path", str(out), "--tiny", "--device",
            "cpu", "--report"])
    assert rc == 0
    assert sorted(f.name for f in out.glob("*.png")) == [
        f"{t:04d}.png" for t in range(1, 10)]
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["device"] == "cpu" and rec["frames"] == 9 and rec["steps"] == 4
    assert rec["vae_decode_ms_per_frame"] > 0
