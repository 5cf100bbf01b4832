"""Prompt embedding for the DiT's text stream.

Port of the JAX ``langscenex_tpu/models/t5.py``: prompts become
[B, 226, embed_dim] embeddings. The real T5 encoder needs a checkpoint
and a tokenizer that the repository does not hold, so only the
deterministic hash-embedding stub is ported; it warns loudly, because
outputs conditioned on it are not comparable with the reference.
Loading a checkpoint raises until the encoder is ported (ROADMAP B2).
"""
from __future__ import annotations

import logging
import warnings
from typing import Optional

import numpy as np

log = logging.getLogger(__name__)


class TextEncoder:
    MAX_LEN = 226     # the reference pipeline's max_sequence_length

    def __init__(self, model_name_or_path: Optional[str] = None,
                 embed_dim: int = 4096):
        self.embed_dim = embed_dim
        if model_name_or_path:
            self._load(model_name_or_path)

    def _load(self, path: str) -> None:
        raise NotImplementedError(
            f"the T5 encoder is not ported yet (ROADMAP B2); cannot load "
            f"{path!r}. Without a checkpoint the hash-embedding stub runs.")

    def encode(self, prompts: list[str]) -> np.ndarray:
        """[B] strings -> [B, MAX_LEN, embed_dim] float32 (the stub:
        per-token embeddings seeded by the token's hash, so cond and
        uncond differ; deterministic within one process)."""
        msg = ("T5 checkpoint not loaded — using the deterministic "
               "hash-embedding STUB for text conditioning; outputs are "
               "NOT parity-comparable")
        log.warning(msg)
        warnings.warn(msg, RuntimeWarning, stacklevel=2)
        out = np.zeros((len(prompts), self.MAX_LEN, self.embed_dim),
                       np.float32)
        for b, p in enumerate(prompts):
            for i, t in enumerate(p.lower().split()[:self.MAX_LEN]):
                rng = np.random.default_rng(abs(hash(t)) % (2 ** 32))
                out[b, i] = rng.normal(0, 0.02, self.embed_dim)
        return out
