"""The T5 text encoder of the PyTorch port vs the JAX package and Hugging
Face on the CPU, in f32: the relative-position buckets of every offset in
[-300, 300] (exactly), the encoder against JAX through
``t5_encoder_from_numpy`` and against ``T5EncoderModel`` through
``load_state_dict(strict=True)``, and ``TextEncoder`` on checkpoint
directories written by ``save_pretrained`` (safetensors, one file and in
shards; pytorch_model.bin) with a tokenizer, the safetensors reader
against the ``safetensors`` package, and the missing-tokenizer refusal.

Tolerances: the JAX and HF comparisons use tests/test_t5.py's bound
(2e-4 absolute + 2e-3 relative); the reader is exact."""
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_threads import few_torch_threads  # noqa: F401

from langscenex_tpu.models import t5_encoder as jt5
from langscenex_tpu.utils.convert import convert_t5_encoder
from langscenex_tpu_torch import convert
from langscenex_tpu_torch.models import t5, t5_encoder

HF_KW = dict(vocab_size=512, d_model=64, d_kv=16, d_ff=128, num_layers=3,
             num_heads=4, feed_forward_proj="gated-gelu",
             relative_attention_num_buckets=32,
             relative_attention_max_distance=128, dropout_rate=0.0,
             layer_norm_epsilon=1e-6)
SMALL = dict(vocab_size=512, d_model=64, d_kv=16, d_ff=128, num_layers=3,
             num_heads=4)
TOL = dict(atol=2e-4, rtol=2e-3)


def _ids(seed=1, T=30):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 512, (2, T))
    mask = np.ones((2, T), np.int64)
    mask[0, 21:] = 0
    return ids, mask


@pytest.mark.parametrize("buckets,dist", [(32, 128), (16, 64), (64, 200)])
def test_buckets_match_jax_for_every_offset(buckets, dist):
    rel = np.arange(-300, 301)
    want = jt5.relative_position_bucket(jnp.asarray(rel), buckets, dist)
    got = t5_encoder.relative_position_bucket(torch.from_numpy(rel), buckets,
                                              dist)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_encoder_matches_jax():
    jm = jt5.T5Encoder(jt5.T5Config(**SMALL))
    ids, mask = _ids()
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(ids, jnp.int32),
                     jnp.asarray(mask, jnp.int32))
    want = jm.apply(params, jnp.asarray(ids, jnp.int32),
                    jnp.asarray(mask, jnp.int32))
    tm = t5_encoder.T5Encoder(t5_encoder.T5Config(**SMALL), device="cpu")
    tm.load_state_dict(convert.t5_encoder_from_numpy(
        jax.tree_util.tree_map(np.asarray, params), device="cpu"),
        strict=True)
    with torch.no_grad():
        got = tm(torch.from_numpy(ids), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.fixture(scope="module")
def hf_model():
    from transformers import T5Config as HFT5Config, T5EncoderModel
    torch.manual_seed(0)
    return T5EncoderModel(HFT5Config(**HF_KW)).eval()


def test_encoder_loads_hf_state_dict_and_matches(hf_model):
    ids, mask = _ids(2)
    with torch.no_grad():
        want = hf_model(input_ids=torch.tensor(ids),
                        attention_mask=torch.tensor(mask)).last_hidden_state
    tm = t5_encoder.T5Encoder(t5_encoder.T5Config(**SMALL), device="cpu")
    tm.load_state_dict(hf_model.state_dict(), strict=True)
    with torch.no_grad():
        got = tm(torch.from_numpy(ids), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)
    # and the JAX converter's tree of the same weights comes back exactly
    sd = {k: v.numpy() for k, v in hf_model.state_dict().items()}
    back = convert.t5_encoder_from_numpy(convert_t5_encoder(sd), "cpu")
    assert back.keys() == sd.keys()
    for k, v in back.items():
        np.testing.assert_array_equal(v.numpy(), sd[k], err_msg=k)


def _write_tokenizer(path):
    from tokenizers import Tokenizer, models, pre_tokenizers
    vocab = {"<pad>": 0, "</s>": 1, "<unk>": 2, "a": 3, "photo": 4,
             "of": 5, "cats": 6}
    tok = Tokenizer(models.WordLevel(vocab, unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    tok.save(str(path / "tokenizer.json"))
    (path / "tokenizer_config.json").write_text(json.dumps(
        {"tokenizer_class": "PreTrainedTokenizerFast", "pad_token": "<pad>",
         "eos_token": "</s>", "unk_token": "<unk>",
         "model_max_length": 512}))


@pytest.mark.parametrize("save_kw", [{}, {"max_shard_size": "100KB"},
                                     {"safe_serialization": False}])
def test_text_encoder_on_hf_directory(hf_model, tmp_path, save_kw):
    hf_model.save_pretrained(tmp_path, **save_kw)
    _write_tokenizer(tmp_path)
    enc = t5.TextEncoder(str(tmp_path), device="cpu")
    out = enc.encode(["a photo of cats"])
    assert out.shape == (1, t5.TextEncoder.MAX_LEN, 64)
    ids = np.zeros((1, t5.TextEncoder.MAX_LEN), np.int64)
    ids[0, :4] = [3, 4, 5, 6]
    mask = (ids > 0).astype(np.int64)
    with torch.no_grad():
        want = hf_model(input_ids=torch.tensor(ids),
                        attention_mask=torch.tensor(mask)
                        ).last_hidden_state.numpy()
    np.testing.assert_allclose(out[0, :4], want[0, :4], **TOL)
    np.testing.assert_allclose(enc.encode_ids(ids, mask), want, **TOL)


def test_safetensors_reader_matches_the_package(tmp_path):
    from safetensors.torch import save_file
    rng = np.random.default_rng(3)
    tensors = {"f32": torch.from_numpy(rng.normal(size=(3, 5)).astype(
        np.float32)), "bf16": torch.from_numpy(rng.normal(size=(7,)).astype(
            np.float32)).bfloat16(),
        "f16": torch.from_numpy(rng.normal(size=(2, 2, 2)).astype(
            np.float16))}
    save_file(tensors, str(tmp_path / "x.safetensors"))
    got = t5.read_safetensors(str(tmp_path / "x.safetensors"))
    assert got.keys() == tensors.keys()
    for k, v in tensors.items():
        np.testing.assert_array_equal(got[k], v.float().numpy()
                                      if k == "bf16" else v.numpy())


def test_missing_tokenizer_raises_and_encode_ids_runs(hf_model, tmp_path,
                                                      monkeypatch):
    hf_model.save_pretrained(tmp_path)
    monkeypatch.setitem(sys.modules, "transformers", None)
    enc = t5.TextEncoder(str(tmp_path), device="cpu")
    with pytest.raises(ImportError, match="tokenizer"):
        enc.encode(["a photo"])
    ids, mask = _ids(4)
    assert np.isfinite(enc.encode_ids(ids, mask)).all()
    with pytest.warns(RuntimeWarning, match="STUB"):
        stub = t5.TextEncoder(embed_dim=8).encode(["a photo"])
    assert stub.shape == (1, t5.TextEncoder.MAX_LEN, 8)


def test_seeded_init_is_finite():
    cfg = t5_encoder.T5Config(**SMALL)
    m = t5_encoder.init_t5_(t5_encoder.T5Encoder(cfg, device="cpu"), 7)
    ids, mask = _ids(5)
    with torch.no_grad():
        out = m(torch.from_numpy(ids), torch.from_numpy(mask))
    assert out.shape == (2, 30, 64) and torch.isfinite(out).all()
    m2 = t5_encoder.init_t5_(t5_encoder.T5Encoder(cfg, device="cpu"), 7)
    assert all(torch.equal(a, b) for a, b in zip(m.parameters(),
                                                 m2.parameters()))
