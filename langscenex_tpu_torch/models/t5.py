"""Prompt embedding for the DiT's text stream.

Port of the JAX ``langscenex_tpu/models/t5.py``: prompts become
[B, 226, embed_dim] embeddings. With a checkpoint directory (Hugging
Face's layout: ``config.json``, the weights, the tokenizer's files) the
T5 encoder of ``models/t5_encoder.py`` runs on ``device``; without one a
deterministic hash-embedding stub runs and warns loudly, because outputs
conditioned on it are not comparable with the reference.

The weights load without ``transformers`` or ``safetensors``:
``model.safetensors`` through a small reader of the format (an 8-byte
little-endian header length, a JSON header, raw little-endian tensors),
``pytorch_model.bin`` through ``torch.load(weights_only=True)``, each
also as shards named by its ``*.index.json``. Only the tokenizer needs
``transformers`` (``AutoTokenizer``, imported when the directory is
loaded): where it is absent ``encode`` raises ``ImportError`` and never
falls back to the stub, while ``encode_ids`` takes token ids without a
tokenizer.
"""
from __future__ import annotations

import json
import logging
import os
import warnings
from typing import Optional

import numpy as np
import torch

from .t5_encoder import T5Config, T5Encoder

log = logging.getLogger(__name__)

_SAFETENSORS_DTYPES = {"F32": np.float32, "F16": np.float16}


def read_safetensors(path: str) -> dict:
    """{name: numpy array} of one ``.safetensors`` file of F32, F16 or
    BF16 tensors (a checkpoint's dtypes); BF16 widens to float32
    (exactly)."""
    with open(path, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
        header = json.loads(f.read(n))
        base = 8 + n
        out = {}
        for name, info in header.items():
            if name == "__metadata__":
                continue
            begin, end = info["data_offsets"]
            f.seek(base + begin)
            raw = f.read(end - begin)
            dt = info["dtype"]
            if dt == "BF16":
                a = (np.frombuffer(raw, "<u2").astype(np.uint32) << 16
                     ).view(np.float32)
            elif dt in _SAFETENSORS_DTYPES:
                a = np.frombuffer(raw, np.dtype(_SAFETENSORS_DTYPES[dt]
                                                ).newbyteorder("<"))
            else:
                raise ValueError(f"{path}: tensor {name} has dtype {dt}, "
                                 f"which this reader does not take")
            out[name] = a.reshape(info["shape"])
    return out


def _weight_files(path: str) -> tuple[list, bool]:
    """The weight files of an HF checkpoint directory and whether they
    are safetensors."""
    for stem, st in (("model.safetensors", True),
                     ("pytorch_model.bin", False)):
        if os.path.exists(os.path.join(path, stem)):
            return [os.path.join(path, stem)], st
        index = os.path.join(path, stem + ".index.json")
        if os.path.exists(index):
            with open(index) as f:
                files = sorted(set(json.load(f)["weight_map"].values()))
            return [os.path.join(path, n) for n in files], st
    raise FileNotFoundError(
        f"{path}: no model.safetensors or pytorch_model.bin (or their "
        f"index.json shards)")


def load_state_dict(path: str) -> dict:
    """The state dict of an HF checkpoint directory as tensors on the
    CPU."""
    files, st = _weight_files(path)
    sd = {}
    for fn in files:
        if st:
            sd.update({k: torch.from_numpy(np.array(v))
                       for k, v in read_safetensors(fn).items()})
        else:
            sd.update(torch.load(fn, map_location="cpu", weights_only=True))
    return sd


def config_from_hf(path: str) -> T5Config:
    with open(os.path.join(path, "config.json")) as f:
        c = json.load(f)
    return T5Config(
        vocab_size=c["vocab_size"], d_model=c["d_model"], d_kv=c["d_kv"],
        d_ff=c["d_ff"], num_layers=c["num_layers"],
        num_heads=c["num_heads"],
        relative_attention_num_buckets=c.get(
            "relative_attention_num_buckets", 32),
        relative_attention_max_distance=c.get(
            "relative_attention_max_distance", 128),
        layer_norm_epsilon=c.get("layer_norm_epsilon", 1e-6))


class TextEncoder:
    MAX_LEN = 226     # the reference pipeline's max_sequence_length

    def __init__(self, model_name_or_path: Optional[str] = None,
                 embed_dim: int = 4096,
                 device: torch.device | str | None = None):
        self.embed_dim = embed_dim
        self.model: Optional[T5Encoder] = None
        self._tok = None
        self._tok_error: Optional[ImportError] = None
        if model_name_or_path:
            self._load(model_name_or_path, device)

    @classmethod
    def from_encoder(cls, model: T5Encoder, tokenizer=None) -> "TextEncoder":
        """A text encoder around a built ``T5Encoder`` (and a tokenizer,
        if any)."""
        enc = cls(embed_dim=model.cfg.d_model)
        enc.model, enc._tok = model.eval(), tokenizer
        return enc

    def _load(self, path: str, device) -> None:
        cfg = config_from_hf(path)
        sd = load_state_dict(path)
        # HF saves the tied embedding under one of its two names
        for a, b in (("shared.weight", "encoder.embed_tokens.weight"),
                     ("encoder.embed_tokens.weight", "shared.weight")):
            if a in sd and b not in sd:
                sd[b] = sd[a]
        model = T5Encoder(cfg, device=device)
        model.load_state_dict(sd, strict=True)
        self.model = model.eval()
        self.embed_dim = cfg.d_model
        try:
            from transformers import AutoTokenizer
        except ImportError as e:
            self._tok_error = e
            return
        self._tok = AutoTokenizer.from_pretrained(path)

    @torch.no_grad()
    def encode_ids(self, input_ids, attention_mask) -> np.ndarray:
        """Token ids [B, T] and their mask (1 = keep) -> [B, T, d_model]
        float32 through the loaded encoder; needs no tokenizer."""
        if self.model is None:
            raise RuntimeError("encode_ids needs a T5 checkpoint")
        out = self.model(torch.as_tensor(np.asarray(input_ids)),
                         torch.as_tensor(np.asarray(attention_mask)))
        return out.float().cpu().numpy()

    def encode(self, prompts: list[str]) -> np.ndarray:
        """[B] strings -> [B, MAX_LEN, embed_dim] float32."""
        if self.model is not None:
            if self._tok is None:
                raise ImportError(
                    "the T5 tokenizer needs `transformers` "
                    "(AutoTokenizer), which is not installed; encode_ids "
                    "takes token ids without it") from self._tok_error
            batch = self._tok(prompts, padding="max_length",
                              max_length=self.MAX_LEN, truncation=True,
                              return_tensors="np")
            return self.encode_ids(batch["input_ids"],
                                   batch["attention_mask"])
        msg = ("T5 checkpoint not loaded — using the deterministic "
               "hash-embedding STUB for text conditioning; outputs are "
               "NOT parity-comparable (pass a checkpoint via --t5)")
        log.warning(msg)
        warnings.warn(msg, RuntimeWarning, stacklevel=2)
        out = np.zeros((len(prompts), self.MAX_LEN, self.embed_dim),
                       np.float32)
        for b, p in enumerate(prompts):
            for i, t in enumerate(p.lower().split()[:self.MAX_LEN]):
                rng = np.random.default_rng(abs(hash(t)) % (2 ** 32))
                out[b, i] = rng.normal(0, 0.02, self.embed_dim)
        return out
