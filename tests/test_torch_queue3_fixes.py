"""Two port-side repairs behind switches whose defaults keep the JAX
package's behaviour (their parity tests, tests/test_torch_vae_train.py
and tests/test_torch_sam.py, run with the defaults):

- ``VAETrainConfig.logvar_in_adam``: the JAX trainer's logvar takes lr
  times the NLL's gradient, a sum over every pixel of the clip; on a
  5x96x96 clip at the default lr 1e-4 that step is about 70 and the loss
  is no longer finite by step 3. With logvar in the VAE's Adam its step
  is about lr, and 5 steps stay finite.
- ``normalize_input`` of SAM1 and SAM2: the reference normalises pixels
  before both encoders (segment_anything's ``Sam.preprocess``: 0-255
  pixels minus its mean over its std, then the zero pad to the square;
  SAM2's ``init_state``: [0, 1] frames with ImageNet's mean and std).
  The encoders' inputs are held EXACTLY against a small torch mirror of
  those two preprocessing steps; ``build_from_checkpoints`` (and so the
  auto-seg CLI) turns both on.
"""
import math

import numpy as np
import pytest
import torch
from test_torch_sam import T_SAM1, T_SAM2
from test_torch_threads import few_torch_threads  # noqa: F401

from langscenex_tpu_torch.autoseg import mask_align
from langscenex_tpu_torch.models import sam1
from langscenex_tpu_torch.models.cogvideox import vae
from langscenex_tpu_torch.models.sam2 import model as sam2
from langscenex_tpu_torch.train import vae as vae_train

VAE_KW = dict(block_out_channels=(4, 8, 8, 8), layers_per_block=1,
              latent_channels=2, norm_groups=2)


def run_vae(logvar_in_adam: bool, steps: int = 5):
    tr = vae_train.VAETrainer(
        vae.VAEConfig(**VAE_KW),
        vae_train.VAETrainConfig(lr=1e-4, disc_start_step=1,
                                 logvar_in_adam=logvar_in_adam),
        seed=0, device="cpu")
    clip = np.random.default_rng(0).uniform(-1, 1, (1, 5, 3, 96, 96)).astype(
        np.float32)
    out = []
    for _ in range(steps):
        m = tr.train_step(clip)
        out.append((m["g_total"], m["nll"], float(tr.state.logvar)))
    return tr, out


@pytest.mark.parametrize("logvar_in_adam", [False, True])
def test_vae_logvar_step(logvar_in_adam):
    tr, out = run_vae(logvar_in_adam)
    finite = [all(math.isfinite(v) for v in rec) for rec in out]
    if not logvar_in_adam:
        # the JAX step: a jump of lr times a sum over 138,240 pixels,
        # then overflow
        assert abs(out[0][2]) > 1.0
        assert not all(finite), out
        return
    assert all(finite), out
    lv = [rec[2] for rec in out]
    # Adam's steps: about lr each, whatever the pixel count
    assert all(abs(b - a) <= 2e-4 for a, b in zip([0.0] + lv, lv)), lv
    assert "logvar" in tr.state.vae_opt.mu
    assert "logvar" not in tr.state.vae_params


# ------------------------------------------------------------------ SAM

SAM_MEAN = torch.tensor([123.675, 116.28, 103.53]).view(-1, 1, 1)
SAM_STD = torch.tensor([58.395, 57.12, 57.375]).view(-1, 1, 1)


def sam_preprocess_mirror(x: torch.Tensor, size: int) -> torch.Tensor:
    """segment_anything's Sam.preprocess on [1,3,h,w] 0-255 pixels:
    normalise, then pad to size x size."""
    x = (x - SAM_MEAN) / SAM_STD
    h, w = x.shape[-2:]
    return torch.nn.functional.pad(x, (0, size - w, 0, size - h))


def recorded_inputs(module):
    seen = []
    inner = module.forward

    def rec(x, *a, **k):
        seen.append(x.clone())
        return inner(x, *a, **k)
    module.forward = rec
    return seen


@pytest.mark.parametrize("normalize", [False, True])
def test_sam1_encoder_input_matches_preprocess(normalize):
    m = sam1.init_sam1_params(sam1.SAM1(T_SAM1, device="cpu",
                                        normalize_input=normalize), 0)
    amg = sam1.SAM1AutomaticMaskGenerator(m, sam1.SAM1AMGConfig(
        points_per_side=2, crop_n_layers=0))
    seen = recorded_inputs(m.image_encoder)
    S = T_SAM1.img_size
    img = torch.from_numpy(np.random.default_rng(1).integers(
        0, 256, (3, S // 2, S)).astype(np.float32) / 255.0)
    amg._process_crop(img, (0, 0, S, S // 2))
    want = sam_preprocess_mirror(img[None] * 255.0, S) if normalize else \
        torch.nn.functional.pad(img[None], (0, 0, 0, S - S // 2))
    # the crop is the model's size already: the resize is the identity
    assert torch.equal(seen[0], want)


@pytest.mark.parametrize("normalize", [False, True])
def test_sam2_encoder_input_matches_init_state(normalize):
    m = sam2.init_sam2_params(sam2.SAM2(T_SAM2, device="cpu",
                                        normalize_input=normalize), 0)
    pred = sam2.SAM2VideoPredictor(m)
    seen = recorded_inputs(m.image_encoder)
    S = T_SAM2.image_size
    frames = np.random.default_rng(2).uniform(0, 1, (2, 3, S, S)).astype(
        np.float32)
    state = pred.init_state(frames)
    pred._frame_feats(state, 1)
    f = torch.from_numpy(frames[1:2])
    mean = torch.tensor([0.485, 0.456, 0.406]).view(-1, 1, 1)
    std = torch.tensor([0.229, 0.224, 0.225]).view(-1, 1, 1)
    assert torch.equal(seen[0], (f - mean) / std if normalize else f)


def test_checkpoints_build_normalising_models(tmp_path, monkeypatch):
    m1 = sam1.SAM1(T_SAM1, device="cpu")
    m2 = sam2.SAM2(T_SAM2, device="cpu")
    torch.save(m1.state_dict(), tmp_path / "sam1.pth")
    torch.save({"model": m2.state_dict()}, tmp_path / "sam2.pt")
    monkeypatch.setattr(sam1, "SAM1Config", lambda: T_SAM1)
    monkeypatch.setattr(sam2, "SAM2Config", lambda image_size: T_SAM2)
    amg, pred = mask_align.build_from_checkpoints(
        str(tmp_path / "sam1.pth"), str(tmp_path / "sam2.pt"),
        image_size=T_SAM2.image_size, device="cpu")
    assert amg.model.normalize_input and pred.model.normalize_input
    assert not sam1.SAM1(T_SAM1, device="cpu").normalize_input
    assert not sam2.SAM2(T_SAM2, device="cpu").normalize_input
