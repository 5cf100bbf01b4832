"""Language lifting in the PyTorch port vs the JAX package on the CPU: the
dense CLIP vision tower and the text tower (HF's keys, held against
``transformers`` and against JAX), ``mask_pool_features``, the scene
autoencoder's forward, ``AETrainer.fit`` from one initial state, the
``lang_features_dim3`` files of ``generate_dim3_features``, the VQ model's
encode/quantize/decode, LSeg's features and the ``lang_features_dim4``
files, ``embed_queries`` -> ``encode_queries_to_lang3``, and
``FieldConstructionPipeline.extract_language_features`` on both branches
(CLIP + AE, and LSeg + VQ), at tiny widths. The JAX models run jitted
on the port's seeded weights through the JAX converters, which the
port's ``*_from_numpy`` invert exactly.

Tolerances: the CLIP towers 2e-5 absolute (tests/test_clip_dense.py's
bound); the pooled rows' segment ids exactly and their values 1e-6; the
autoencoder forward 1e-5 absolute and its running statistics 1e-6; the
trainer (see ``test_ae_fit_matches_jax``: its training is chaotic) its
train losses 1e-5 relative over 4 steps and its eval losses 1e-4, the
best epoch exactly, its weights and statistics within 2 lr per step; the
3-d maps of an AE trained 3-4 steps in each package 1e-3 absolute
(unit-norm codes of weights that moved at most 4 lr apart), and the query
codes of one AE state 1e-5; the VQ model and LSeg 1e-5 absolute + 1e-4
relative, the VQ code indices exactly."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_threads import few_torch_threads  # noqa: F401

from langscenex_tpu.eval import open_vocab as jov
from langscenex_tpu.models import clip_dense as jclip
from langscenex_tpu.models import lseg as jlseg
from langscenex_tpu.models import openseg as jopenseg
from langscenex_tpu.models import vq_model as jvq
from langscenex_tpu.models.autoencoder import Autoencoder as JAutoencoder
from langscenex_tpu.pipeline import FieldConstructionPipeline as JPipeline
from langscenex_tpu.pipeline import PipelinePaths as JPaths
from langscenex_tpu.train import ae as jae
from langscenex_tpu.utils.convert import (convert_autoencoder,
                                          convert_clip_text,
                                          convert_clip_vision,
                                          convert_vq_model)
from langscenex_tpu_torch import convert
from langscenex_tpu_torch.eval import open_vocab as tov
from langscenex_tpu_torch.models import clip_dense as tclip
from langscenex_tpu_torch.models import lseg as tlseg
from langscenex_tpu_torch.models import openseg as topenseg
from langscenex_tpu_torch.models import vq_model as tvq
from langscenex_tpu_torch.pipeline import (FieldConstructionPipeline,
                                           PipelinePaths)
from langscenex_tpu_torch.train import ae as tae
from langscenex_tpu_torch.utils import png

RNG = np.random.default_rng(0)
CLIP_KW = dict(hidden_size=32, intermediate_size=64, num_layers=2,
               num_heads=4, patch_size=14, image_size=28, projection_dim=16)
TEXT_KW = dict(vocab_size=99, hidden_size=32, intermediate_size=64,
               num_layers=2, num_heads=4, max_positions=16,
               projection_dim=16, eos_token_id=98)
LSEG_KW = dict(hidden_size=16, intermediate_size=32, num_layers=2,
               num_heads=2, patch_size=8, image_size=32, projection_dim=12)
VQ_KW = dict(in_channels=16, out_channels=16, latent_channels=4,
             norm_num_groups=2, block_out_channels=(8, 6, 4),
             layers_per_block=1, num_vq_embeddings=16)
TOL = dict(atol=1e-5, rtol=1e-4)


def _np(sd):
    """Copies: JAX on the CPU may alias a numpy buffer, and the port
    updates its weights and running statistics in place."""
    return {k: v.numpy().copy() for k, v in sd.items()}


def _jnp(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def assert_same_state(got: dict, want: dict):
    assert got.keys() == want.keys()
    for k, v in got.items():
        np.testing.assert_array_equal(v.numpy(), want[k], err_msg=k)


@pytest.fixture(scope="module")
def clip():
    tm = tclip.init_clip_params(tclip.CLIPVisionDense(
        tclip.CLIPVisionConfig(**CLIP_KW), device="cpu"), 1).eval()
    sd = _np(tm.state_dict())
    params = _jnp(convert_clip_vision(sd))
    assert_same_state(convert.clip_vision_from_numpy(params, "cpu"), sd)
    return tm, params, jclip.CLIPVisionConfig(**CLIP_KW)


@pytest.fixture(scope="module")
def text():
    tm = tclip.init_clip_params(tclip.CLIPTextEncoder(
        tclip.CLIPTextConfig(**TEXT_KW), device="cpu"), 2).eval()
    sd = _np(tm.state_dict())
    params = _jnp(convert_clip_text(sd))
    assert_same_state(convert.clip_text_from_numpy(params, "cpu"), sd)
    return tm, params, jclip.CLIPTextConfig(**TEXT_KW)


# ------------------------------------------------------------- CLIP

@pytest.mark.parametrize("hw", [(28, 28), (42, 56)])
def test_clip_vision_matches_jax(clip, hw):
    tm, params, jcfg = clip
    img = RNG.normal(size=(2, 3) + hw).astype(np.float32)
    with torch.no_grad():
        pooled, dense = tm(torch.from_numpy(img))
    jp, jd = jax.jit(lambda p, x: jclip.CLIPVisionDense(jcfg).apply(
        {"params": p}, x))(params, jnp.asarray(img.transpose(0, 2, 3, 1)))
    np.testing.assert_allclose(pooled.numpy(), np.asarray(jp), atol=2e-5)
    np.testing.assert_allclose(dense.numpy(),
                               np.asarray(jd).transpose(0, 3, 1, 2),
                               atol=2e-5)


def test_clip_text_matches_jax(text):
    tm, params, jcfg = text
    ids = RNG.integers(1, 97, (2, 16)).astype(np.int32)
    ids[0, 7], ids[1, 12] = 98, 98
    with torch.no_grad():
        got = tm(torch.from_numpy(ids).long())
    want = jax.jit(lambda p, x: jclip.CLIPTextEncoder(jcfg).apply(
        {"params": p}, x))(params, jnp.asarray(ids))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


def test_clip_towers_load_hf_state_dicts():
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(0)
    hv = transformers.CLIPVisionModelWithProjection(
        transformers.CLIPVisionConfig(
            hidden_size=32, intermediate_size=64, num_hidden_layers=2,
            num_attention_heads=4, image_size=28, patch_size=14,
            projection_dim=16)).eval()
    tv = tclip.CLIPVisionDense(tclip.CLIPVisionConfig(**CLIP_KW),
                               device="cpu").eval()
    tv.load_state_dict(hv.state_dict(), strict=True)
    img = torch.from_numpy(RNG.normal(size=(2, 3, 28, 28)).astype(
        np.float32))
    ht = transformers.CLIPTextModelWithProjection(
        transformers.CLIPTextConfig(
            hidden_size=32, intermediate_size=64, num_hidden_layers=2,
            num_attention_heads=4, vocab_size=99, max_position_embeddings=16,
            projection_dim=16, eos_token_id=98, bos_token_id=97,
            pad_token_id=0)).eval()
    tt = tclip.CLIPTextEncoder(tclip.CLIPTextConfig(**TEXT_KW),
                               device="cpu").eval()
    tt.load_state_dict(ht.state_dict(), strict=True)
    ids = torch.from_numpy(RNG.integers(1, 97, (2, 16)))
    ids[0, 5] = 98
    ids[1, 15] = 98
    with torch.no_grad():
        np.testing.assert_allclose(tv(img)[0].numpy(),
                                   hv(pixel_values=img).image_embeds.numpy(),
                                   atol=2e-5)
        np.testing.assert_allclose(tt(ids).numpy(),
                                   ht(input_ids=ids).text_embeds.numpy(),
                                   atol=2e-5)


def test_mask_pool_features_match_jax():
    feat = RNG.normal(size=(16, 20, 24)).astype(np.float32)
    seg = RNG.integers(-1, 6, (20, 24))
    seg[seg == 3] = 4                        # an absent id is skipped
    got = topenseg.mask_pool_features(feat, seg)
    want = jopenseg.mask_pool_features(feat, seg)
    assert got.shape == want.shape == (6, 16)
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_openseg_extractor_names_tensorflow(monkeypatch):
    import sys
    monkeypatch.setitem(sys.modules, "tensorflow", None)
    with pytest.raises(RuntimeError, match="tensorflow"):
        topenseg.OpenSegExtractor("/no/model")


# -------------------------------------------------------- autoencoder

def seeded_trainers(input_dim, seed=42):
    """The port's AETrainer and a JAX AETrainer from the same weights."""
    tt = tae.AETrainer(seed=seed, input_dim=input_dim, device="cpu")
    jt = jae.AETrainer(input_dim=input_dim)
    v = _jnp(convert_autoencoder(_np(tt.model.state_dict())))
    jt.params, jt.batch_stats = v["params"], v["batch_stats"]
    jt.opt_state = jt.tx.init(jt.params)
    return tt, jt


def _jax_ae_state(jt):
    return convert.autoencoder_from_numpy(
        {"params": jax.tree_util.tree_map(np.asarray, jt.params),
         "batch_stats": jax.tree_util.tree_map(np.asarray, jt.batch_stats)},
        device="cpu")


def test_autoencoder_forward_matches_jax():
    tt, jt = seeded_trainers(32)
    sd = _np(tt.model.state_dict())
    assert_same_state(_jax_ae_state(jt), sd)
    x = RNG.normal(size=(20, 32)).astype(np.float32)
    m = tt.model.train()
    with torch.no_grad():
        got_train = m(torch.from_numpy(x)).numpy()
    want_train, upd = jt.model.apply(
        {"params": jt.params, "batch_stats": jt.batch_stats}, x, train=True,
        mutable=["batch_stats"])
    np.testing.assert_allclose(got_train, np.asarray(want_train), atol=1e-5)
    for j in range(6):
        bn = m.encoder[3 * j + 1]
        st = upd["batch_stats"]["encoder"][f"BatchNorm_{j}"]
        np.testing.assert_allclose(bn.running_mean.numpy(),
                                   np.asarray(st["mean"]), atol=1e-6)
        np.testing.assert_allclose(bn.running_var.numpy(),
                                   np.asarray(st["var"]), atol=1e-6)
    m.eval()
    with torch.no_grad():
        got = m.encode(torch.from_numpy(x)).numpy()
    want = jt.model.apply({"params": jt.params,
                           "batch_stats": upd["batch_stats"]}, x,
                          method=JAutoencoder.encode)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5)


def rows(n, d, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(4, d))
    r = np.repeat(centers, n // 4, 0) + 0.1 * rng.normal(size=(n, d))
    return (r / np.linalg.norm(r, axis=-1, keepdims=True)).astype(
        np.float32)


def record_jax_losses(jt):
    """Wrap the JAX trainer's jitted steps to record their losses."""
    train, evals = [], []
    ts, es = jt._train_step, jt._eval_step

    def t(*a):
        out = ts(*a)
        train.append(float(out[-1]))
        return out

    def e(*a):
        out = es(*a)
        evals.append(float(out))
        return out
    jt._train_step, jt._eval_step = t, e
    return train, evals


def test_ae_fit_matches_jax():
    """Two epochs of two steps, evaluated after each. Training this AE is
    chaotic: Adam moves every weight by about lr whatever its gradient's
    size, so where a gradient is rounding noise (the biases before a batch
    norm have a zero gradient) the two packages step differently, and
    after some 48 steps JAX itself lands 8% apart in eval loss from a
    start one ulp away. So the losses are held over these 4 steps, and the
    weights and statistics within 2 lr per step."""
    feats = rows(200, 32)
    tt, jt = seeded_trainers(32)
    j_train, j_evals = record_jax_losses(jt)
    epochs, bs, steps = 2, 96, 2
    got = tt.fit(feats, num_epochs=epochs, batch_size=bs,
                 eval_from_epoch=-1)
    want = jt.fit(feats, num_epochs=epochs, batch_size=bs,
                  eval_from_epoch=-1)
    np.testing.assert_allclose(got, want, rtol=1e-4)
    t_train = [v for _, v in tt.history["train"]]
    np.testing.assert_allclose(t_train, j_train[steps - 1::steps], rtol=1e-5)
    n_b = -(-200 // bs)
    j_ev = [sum(j_evals[i * n_b + b] * min(bs, 200 - b * bs)
                for b in range(n_b)) / 200 for i in range(epochs)]
    # the eval losses read the running means, which carry the noise-driven
    # biases: 1e-4
    np.testing.assert_allclose([v for _, v in tt.history["eval"]], j_ev,
                               rtol=1e-4)
    assert tt.best_epoch == int(np.argmin(j_ev))
    sd = tt.model.state_dict()
    for k, v in _jax_ae_state(jt).items():
        if k.endswith("num_batches_tracked"):
            assert int(sd[k]) == epochs * steps
            continue
        np.testing.assert_allclose(sd[k].numpy(), v.numpy(), err_msg=k,
                                   atol=2 * 1e-4 * epochs * steps)


def test_generate_dim3_features_match_jax(tmp_path):
    n_frames, H, W, d = 2, 12, 16, 32
    lf = tmp_path / "lang_features"
    seg_dir = tmp_path / "segs"
    lf.mkdir()
    seg_dir.mkdir()
    for i in range(n_frames):
        seg = RNG.integers(-1, 5, (H, W))
        np.save(seg_dir / f"{i + 1:04d}_s.npy", seg)
        np.save(lf / f"{i + 1:04d}.npy", rows(len(np.unique(seg)) * 4, d,
                                              seed=i)[::4])
    tt, jt = seeded_trainers(d)
    tae.generate_dim3_features(str(lf), str(seg_dir), str(tmp_path / "t"),
                               trainer=tt, num_epochs=4)
    jae.generate_dim3_features(str(lf), str(seg_dir), str(tmp_path / "j"),
                               trainer=jt, num_epochs=4)
    for i in range(n_frames):
        a = np.load(tmp_path / "t" / f"{i + 1:04d}_f.npy")
        b = np.load(tmp_path / "j" / f"{i + 1:04d}_f.npy")
        assert a.shape == b.shape == (3, H, W) and a.dtype == b.dtype
        np.testing.assert_allclose(a, b, atol=1e-3)


# ------------------------------------------------------------ VQ, LSeg

@pytest.fixture(scope="module")
def vq():
    tm = tvq.init_vq_params(tvq.VQModel(tvq.VQConfig(**VQ_KW),
                                        device="cpu"), 3).eval()
    sd = _np(tm.state_dict())
    params = _jnp(convert_vq_model(sd))
    assert_same_state(convert.vq_model_from_numpy(params, "cpu"), sd)
    return tm, params, jvq.VQModel(jvq.VQConfig(**VQ_KW))


def test_vq_model_matches_jax(vq):
    tm, params, jm = vq
    x = RNG.normal(size=(1, 16, 24, 16)).astype(np.float32)
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy())
    run = jax.jit(lambda p, x, method: jm.apply(p, x, method=method),
                  static_argnums=2)
    with torch.no_grad():
        z = tm.encode(xt)
        zq, idx = tm.quantize_latents(z)
        y = tm(xt)
    jz = run(params, jnp.asarray(x), jm.encode)
    jzq, jidx = run(params, jz, jm.quantize)
    np.testing.assert_allclose(z.numpy(), np.asarray(jz).transpose(
        0, 3, 1, 2), **TOL)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(zq.numpy(), np.asarray(jzq).transpose(
        0, 3, 1, 2))
    np.testing.assert_allclose(y.numpy(), np.asarray(
        run(params, jnp.asarray(x), jm.__call__)).transpose(0, 3, 1, 2),
        **TOL)


@pytest.fixture(scope="module")
def lseg():
    tm = tclip.init_clip_params(tclip.CLIPVisionDense(
        tclip.CLIPVisionConfig(**LSEG_KW), device="cpu"), 4).eval()
    params = _jnp(convert_clip_vision(_np(tm.state_dict())))
    return (tlseg.LSegFeatureExtractor(tm, out_dim=16),
            jlseg.LSegFeatureExtractor(
                params, jclip.CLIPVisionConfig(**LSEG_KW), out_dim=16), tm)


def test_lseg_features_match_jax(lseg):
    t, j, _ = lseg
    img = RNG.integers(0, 256, (24, 30, 3), np.uint8)
    got = t.extract_features(img).numpy()
    want = np.asarray(j.extract_features(img))
    assert got.shape == want.shape == (1, 16, 24, 30)
    np.testing.assert_allclose(got, want, **TOL)


def write_scene(root, n=2, h=24, w=32):
    os.makedirs(os.path.join(root, "input"))
    os.makedirs(os.path.join(root, "lang_features_dim3"))
    rng = np.random.default_rng(7)
    for i in range(n):
        png.write_png(os.path.join(root, "input", f"{i + 1:04d}.png"),
                      rng.integers(0, 256, (h, w, 3), np.uint8))
        seg = rng.integers(-1, 4, (h, w))
        seg[:, :4] = 5                               # id 4 stays absent
        np.save(os.path.join(root, "lang_features_dim3", f"{i + 1:04d}_s.npy"),
                seg)
    return root


def test_lseg_dim4_files_match_jax(tmp_path, lseg, vq):
    t, j, _ = lseg
    tm, params, jm = vq
    a, b = write_scene(str(tmp_path / "t")), write_scene(str(tmp_path / "j"))
    assert tlseg.generate_lang_features_with_lseg(a, t, tm, (40, 32)) == 2
    jlseg.generate_lang_features_with_lseg(b, j, jm, params, (40, 32))
    for i in range(2):
        x = np.load(os.path.join(a, "lang_features_dim4", f"{i + 1:04d}_f.npy"))
        y = np.load(os.path.join(b, "lang_features_dim4", f"{i + 1:04d}_f.npy"))
        assert x.shape == y.shape == (1, 4, 8, 10)
        np.testing.assert_allclose(x, y, **TOL)


# ------------------------------------------------- queries, pipeline

class Tokenizer:
    """A stand-in for HF's CLIPTokenizer: one id per character."""

    def __call__(self, texts, padding, max_length, truncation,
                 return_tensors):
        ids = np.zeros((len(texts), max_length), np.int64)
        for r, t in enumerate(texts):
            toks = [97] + [1 + ord(c) % 90 for c in t][:max_length - 2] + [98]
            ids[r, :len(toks)] = toks
        return {"input_ids": ids}


def test_queries_match_jax(text):
    tm, params, jcfg = text
    texts = ["a grey sofa", "lamp", "the window by the door"]
    got = tov.embed_queries(texts, tm, Tokenizer())
    want = jov.embed_queries(texts, jclip.CLIPTextEncoder(jcfg), params,
                             Tokenizer())
    np.testing.assert_allclose(got, want, atol=2e-5)
    # an AE trained a few epochs by the port, its state carried to JAX
    tt, jt = seeded_trainers(16)
    tt.fit(rows(96, 16), num_epochs=2, batch_size=48, eval_from_epoch=0)
    v = _jnp(convert_autoencoder(_np(tt.model.state_dict())))
    jt.params, jt.batch_stats = v["params"], v["batch_stats"]
    codes = tov.encode_queries_to_lang3(got, tt)
    assert codes.shape == (3, 3)
    np.testing.assert_allclose(codes, jov.encode_queries_to_lang3(want, jt),
                               atol=1e-5)


def test_extract_language_features_clip_branch_matches_jax(
        tmp_path, clip, monkeypatch):
    """The port's pipeline builds its extractor from a checkpoint; the
    JAX pipeline takes its extractor and a JAX AE trainer from the port
    trainer's initial weights."""
    tm, params, jcfg = clip
    a, b = write_scene(str(tmp_path / "t")), write_scene(str(tmp_path / "j"))
    ckpt = str(tmp_path / "clip.pt")
    torch.save(tm.state_dict(), ckpt)
    common = dict(skip_video_process=True, skip_pose_estimate=True)
    tp = FieldConstructionPipeline(PipelinePaths(data_path=a, clip_ckpt=ckpt,
                                                 **common),
                                   ae_epochs=3, device="cpu")
    tp.clip_cfg = tclip.CLIPVisionConfig(**CLIP_KW)
    tp.preprocess()

    jax_trainer = jae.AETrainer

    class SeededJAXTrainer(jax_trainer):
        def __init__(self, input_dim):
            super().__init__(input_dim=input_dim)
            v = _jnp(convert_autoencoder(_np(tae.AETrainer(
                input_dim=input_dim, device="cpu").model.state_dict())))
            self.params, self.batch_stats = v["params"], v["batch_stats"]
            self.opt_state = self.tx.init(self.params)
    monkeypatch.setattr(jae, "AETrainer", SeededJAXTrainer)
    jp = JPipeline(JPaths(data_path=b, **common), ae_epochs=3)
    jp.lang_extractor = jclip.ClipDenseExtractor(params, jcfg)
    jp.preprocess()
    for i in range(2):
        name = f"{i + 1:04d}"
        x = np.load(os.path.join(a, "lang_features", name + ".npy"))
        y = np.load(os.path.join(b, "lang_features", name + ".npy"))
        assert x.shape == y.shape == (6, 16)      # ids -1..3 and 5
        np.testing.assert_allclose(x, y, atol=2e-5)
        f_t = np.load(os.path.join(a, "lang_features_dim3", name + "_f.npy"))
        f_j = np.load(os.path.join(b, "lang_features_dim3", name + "_f.npy"))
        assert f_t.shape == f_j.shape == (3, 24, 32)
        np.testing.assert_allclose(f_t, f_j, atol=1e-3)
    assert isinstance(tp.ae_trainer, tae.AETrainer)


def test_extract_language_features_lseg_branch(tmp_path, lseg, vq):
    """Without its checkpoint the LSeg branch writes nothing (as the JAX
    pipeline); with them it writes what generate_lang_features_with_lseg
    writes for the same models (held against JAX above)."""
    clip_tm, vq_tm = lseg[2], vq[0]
    root = write_scene(str(tmp_path / "s"))
    paths = PipelinePaths(data_path=root, skip_video_process=True,
                          skip_pose_estimate=True,
                          feature_extractor_type="lseg")
    pipe = FieldConstructionPipeline(paths, device="cpu")
    pipe.extract_language_features()
    assert not os.path.isdir(os.path.join(root, "lang_features_dim4"))
    paths.lseg_ckpt = str(tmp_path / "lseg.pt")
    paths.sem_ae_ckpt = str(tmp_path / "vq.pt")
    torch.save(clip_tm.state_dict(), paths.lseg_ckpt)
    torch.save(vq_tm.state_dict(), paths.sem_ae_ckpt)
    pipe.clip_cfg = tclip.CLIPVisionConfig(**LSEG_KW)
    pipe.vq_cfg = tvq.VQConfig(**VQ_KW)
    pipe.preprocess()
    direct = write_scene(str(tmp_path / "d"))
    assert tlseg.generate_lang_features_with_lseg(
        direct, tlseg.LSegFeatureExtractor(clip_tm, out_dim=16), vq_tm) == 2
    for i in range(2):
        name = f"{i + 1:04d}_f.npy"
        x = np.load(os.path.join(root, "lang_features_dim4", name))
        assert x.shape == (1, 4, 120, 160) and np.isfinite(x).all()
        np.testing.assert_array_equal(
            x, np.load(os.path.join(direct, "lang_features_dim4", name)))
