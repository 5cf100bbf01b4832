"""The language-autoencoder trainer and the per-pixel 3-d feature maps, port
of the JAX ``train/ae.py`` (the reference's Preprocessor.
generate_lang_features_with_openseg, field_construction/preprocessor.py
:146-227): 400 epochs, batch 512, Adam 1e-4, train loss L2 + 0.001 cos,
eval loss (after epoch 300) L2 + cos, the best checkpoint kept by eval
loss; then every frame's pooled feature rows are encoded to 3-d and
scattered into per-pixel ``*_f.npy`` maps by the ``*_s.npy`` segment ids
(ids from -1 upward, absent ids skipped; preprocessor.py:214-227).

The cos term is the reference's loss_utils.cos_loss: the cosine along
axis 0. Adam is optax's arithmetic (``train/optim.GroupAdam``), run once
over one flat vector that holds every weight (the model's parameters
are views of it), so a step launches a few kernels for the update and
not a few per weight; the arithmetic is elementwise, so each weight's
step is the per-tensor one. The epoch permutations come from
``np.random.default_rng(0)`` and the whole [N, D] feature matrix sits on
``device``.
"""
from __future__ import annotations

import glob
import os
from typing import Optional

import numpy as np
import torch

from ..models.autoencoder import (DECODER_DIMS, Autoencoder, cos_loss_axis0,
                                  init_autoencoder_params, l2_loss)
from ..utils.device import resolve_device
from .optim import GroupAdam


class AETrainer:
    """``model`` (an ``Autoencoder``) with seeded random weights unless the
    caller gives its state; ``history`` records (epoch, train loss of the
    epoch's last step) and (epoch, eval loss) of the last ``fit``."""

    def __init__(self, seed: int = 42, lr: float = 1e-4,
                 input_dim: int = 768,
                 device: torch.device | str | None = None):
        self.device = resolve_device(device)
        dec = tuple(DECODER_DIMS[:-1]) + (input_dim,)
        self.model = init_autoencoder_params(
            Autoencoder(decoder_dims=dec, input_dim=input_dim,
                        device=self.device), seed)
        self._leaves = list(self.model.parameters())
        self.flat = torch.cat([p.detach().reshape(-1)
                               for p in self._leaves])
        off = 0
        with torch.no_grad():
            for p in self._leaves:      # each weight a view of ``flat``
                p.data = self.flat[off:off + p.numel()].view(p.shape)
                off += p.numel()
        self.adam = GroupAdam(lambda count: {"flat": lr})
        self.opt_state = self.adam.init({"flat": self.flat})
        self.history = {"train": [], "eval": []}

    def state_dict(self) -> dict:
        return {k: v.detach().clone()
                for k, v in self.model.state_dict().items()}

    def train_step(self, batch: torch.Tensor) -> torch.Tensor:
        """One Adam step on ``batch`` (batch statistics, running averages
        updated); returns the loss before the step."""
        self.model.train()
        out = self.model(batch)
        loss = l2_loss(out, batch) + 0.001 * cos_loss_axis0(out, batch)
        grads = torch.autograd.grad(loss, self._leaves)
        new, self.opt_state = self.adam.update(
            {"flat": torch.cat([g.reshape(-1) for g in grads])},
            self.opt_state, {"flat": self.flat})
        with torch.no_grad():
            self.flat.copy_(new["flat"])
        return loss.detach()

    @torch.no_grad()
    def eval_loss(self, batch: torch.Tensor) -> torch.Tensor:
        self.model.eval()
        out = self.model(batch)
        return l2_loss(out, batch) + cos_loss_axis0(out, batch)

    def fit(self, features: np.ndarray, num_epochs: int = 400,
            batch_size: int = 512, eval_from_epoch: int = 300,
            log_every: int = 0) -> float:
        """features: [N, D], every frame's pooled rows. Returns the best
        eval loss (the weights are left at its epoch), or the last train
        loss when no epoch was evaluated."""
        n = features.shape[0]
        feats = torch.as_tensor(np.asarray(features, np.float32),
                                device=self.device)
        best = (np.inf, None, -1)
        rng = np.random.default_rng(0)
        steps = max(1, n // batch_size) if n >= batch_size else 1
        self.history = {"train": [], "eval": []}
        loss = torch.zeros(())
        for epoch in range(num_epochs):
            perm = torch.from_numpy(rng.permutation(n)).to(self.device)
            for s in range(steps):
                idx = perm[s * batch_size:(s + 1) * batch_size]
                if len(idx) == 0:
                    continue
                loss = self.train_step(feats[idx])
            self.history["train"].append((epoch, loss))
            if epoch > eval_from_epoch:
                ev = sum(float(self.eval_loss(feats[s:s + batch_size]))
                         * min(batch_size, n - s)
                         for s in range(0, n, batch_size)) / n
                self.history["eval"].append((epoch, ev))
                if ev < best[0]:
                    best = (ev, self.state_dict(), epoch)
            if log_every and epoch % log_every == 0:
                print(f"[ae epoch {epoch}] loss={float(loss):.6f}")
        self.history["train"] = [(e, float(v))
                                 for e, v in self.history["train"]]
        self.best_epoch = best[2]
        if best[1] is not None:
            self.model.load_state_dict(best[1])
            return best[0]
        return float(loss)

    @torch.no_grad()
    def encode(self, features: np.ndarray) -> np.ndarray:
        self.model.eval()
        return self.model.encode(torch.as_tensor(
            np.asarray(features, np.float32), device=self.device)
        ).cpu().numpy()

    @torch.no_grad()
    def decode(self, z: np.ndarray) -> np.ndarray:
        self.model.eval()
        return self.model.decode(torch.as_tensor(
            np.asarray(z, np.float32), device=self.device)).cpu().numpy()


def scatter_seg_features(lang_feat: np.ndarray, seg: np.ndarray
                         ) -> np.ndarray:
    """[n_rows, 3] encoded rows + [H,W] seg ids -> [3,H,W] per-pixel map;
    the rows belong to the ids present, from -1 upward (preprocessor.py
    :214-227)."""
    H, W = seg.shape
    out = np.zeros((3, H, W), np.float32)
    curr = 0
    for color_id in range(-1, int(seg.max()) + 1):
        m = seg == color_id
        if not m.any():
            continue
        out[:, m] = lang_feat[curr][:, None]
        curr += 1
    return out


def generate_dim3_features(lang_features_dir: str, seg_dir: str,
                           out_dir: str, trainer: Optional[AETrainer] = None,
                           num_epochs: int = 400,
                           device: torch.device | str | None = None
                           ) -> AETrainer:
    """The tail of stage 3: train the AE on every frame's pooled rows, then
    write the per-pixel ``*_f.npy`` maps beside the ``*_s.npy`` segments."""
    names = sorted(glob.glob(os.path.join(lang_features_dir, "*.npy")))
    feats = [np.load(n) for n in names]
    all_feats = np.concatenate(feats, axis=0)
    if trainer is None:
        trainer = AETrainer(input_dim=all_feats.shape[1], device=device)
    trainer.fit(all_feats, num_epochs=num_epochs)
    os.makedirs(out_dir, exist_ok=True)
    for idx, f in enumerate(feats):
        seg = np.load(os.path.join(seg_dir, f"{idx + 1:04d}_s.npy"))
        if seg.ndim == 3:
            seg = seg[0]
        np.save(os.path.join(out_dir, f"{idx + 1:04d}_f.npy"),
                scatter_seg_features(trainer.encode(f), seg))
    return trainer
