"""3D causal VAE fine-tune trainer (GAN-augmented).

Port of the JAX ``langscenex_tpu/train/vae.py``: the reconstruction NLL
(optionally LPIPS-weighted) + KL + an adversarial term with LeCam
regularisation, with alternating G and D updates, as the reference's
losses structure them.

One ``train_step`` does, as the JAX step does:

- G: the VAE's forward with noise ``eps``, the NLL + KL, D's logits on
  the reconstruction and the generator loss, weighted by ``disc_weight``
  from ``disc_start_step`` on (0 before, so its gradient is 0); Adam
  (b1 0.5, b2 0.9, optax's arithmetic through ``train/optim.GroupAdam``)
  on the VAE, and a plain SGD step of ``lr`` on the scalar output
  ``logvar`` (or, with ``VAETrainConfig.logvar_in_adam``, logvar in that
  Adam, so that its step does not grow with the clip's pixel count);
- D: the hinge (or vanilla) loss on the batch and the detached
  reconstruction plus ``lecam_weight`` times the LeCam regulariser; its
  own Adam's moments and count always advance, its parameters only from
  ``disc_start_step`` on;
- the LeCam EMA takes D's logits of this step, and ``step`` counts up.

The state is a ``VAETrainState`` of tensors in the models' state_dict
keys, so ``convert.vae_train_state_from_numpy`` carries a JAX state
across. The noise is drawn from the trainer's ``torch.Generator`` unless
``eps`` is given.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.func import functional_call

from ..models.cogvideox.losses import (LeCamEMA, VAELossConfig,
                                       discriminator_loss, generator_loss,
                                       lecam_reg, vae_loss)
from ..models.cogvideox.vae import AutoencoderKL3D, VAEConfig
from ..utils.device import resolve_device
from .optim import AdamState, GroupAdam


def same_pad(n: int, k: int, s: int) -> tuple:
    """XLA's 'SAME' padding of one axis: (lo, hi) with the odd pixel at
    the end."""
    out = -(-n // s)
    total = max((out - 1) * s + k - n, 0)
    return total // 2, total - total // 2


class Discriminator3D(nn.Module):
    """PatchGAN-style 3D discriminator: three (3, 4, 4) stride-(1, 2, 2)
    convs with leaky ReLU 0.2 and a (3, 3, 3) head, each with XLA's
    'SAME' padding (an odd H or W pads one more at the end, which
    ``nn.Conv3d``'s symmetric padding cannot)."""

    def __init__(self, base: int = 32, device: torch.device | str | None = None):
        super().__init__()
        with torch.device(resolve_device(device)):
            cin = 3
            for i, mult in enumerate((1, 2, 4)):
                setattr(self, f"conv_{i}", nn.Conv3d(cin, base * mult,
                                                     (3, 4, 4), (1, 2, 2)))
                cin = base * mult
            self.head = nn.Conv3d(cin, 1, 3)

    @staticmethod
    def _conv(conv: nn.Conv3d, x: torch.Tensor) -> torch.Tensor:
        pads = []
        for n, k, s in zip(reversed(x.shape[2:]), reversed(conv.kernel_size),
                           reversed(conv.stride)):
            pads += same_pad(n, k, s)
        return conv(F.pad(x, pads))

    def forward(self, video: torch.Tensor) -> torch.Tensor:
        """[B,T,3,H,W] -> [B, t', h', w'] logits."""
        x = video.permute(0, 2, 1, 3, 4)
        for i in range(3):
            x = F.leaky_relu(self._conv(getattr(self, f"conv_{i}"), x), 0.2)
        return self._conv(self.head, x)[:, 0]


@dataclasses.dataclass
class VAETrainConfig:
    lr: float = 1e-4
    disc_lr: float = 1e-4
    kl_weight: float = 1e-6
    disc_weight: float = 0.5
    lecam_weight: float = 0.1
    disc_start_step: int = 0
    gan_kind: str = "hinge"
    # False: logvar takes the JAX package's plain SGD step, lr times the
    # NLL's gradient, a sum over every pixel of the clip (at 9x256x256 the
    # default lr overflows the loss by step 3). True: logvar is one more
    # parameter of the VAE's Adam, as in the reference's trainer.
    logvar_in_adam: bool = False


@dataclasses.dataclass
class VAETrainState:
    vae_params: dict           # AutoencoderKL3D state_dict keys
    disc_params: dict          # Discriminator3D state_dict keys
    vae_opt: AdamState
    disc_opt: AdamState
    logvar: torch.Tensor       # scalar
    lecam: LeCamEMA
    step: int


LOGVAR = "logvar"               # its key in the VAE's Adam with the switch


def _adam(lr: float, params: dict) -> GroupAdam:
    lrs = {k: lr for k in params}
    return GroupAdam(lr_fn=lambda count: lrs, b1=0.5, b2=0.9)


class VAETrainer:
    """The VAE (``vae_cfg``) and D on ``device`` (the GPU unless the caller
    names another) with seeded random weights; ``lpips_fn(recon, target)``
    takes [B,T,3,H,W] pairs (``models.lpips.per_frame``)."""

    def __init__(self, vae_cfg: VAEConfig = VAEConfig(),
                 cfg: VAETrainConfig = VAETrainConfig(), seed: int = 0,
                 lpips_fn: Optional[Callable] = None,
                 device: torch.device | str | None = None):
        dev = resolve_device(device)
        self.cfg = cfg
        self.device = dev
        with torch.random.fork_rng(devices=[dev] if dev.type == "cuda"
                                   else []):
            torch.manual_seed(seed)
            self.vae = AutoencoderKL3D(vae_cfg, device=dev)
            self.disc = Discriminator3D(device=dev)
        self.lpips_fn = lpips_fn
        self.gen = torch.Generator(device=dev).manual_seed(seed)
        vp = {k: v.detach() for k, v in self.vae.state_dict().items()}
        dp = {k: v.detach() for k, v in self.disc.state_dict().items()}
        zero = torch.zeros((), device=dev)
        opt_params = {**vp, LOGVAR: zero} if cfg.logvar_in_adam else vp
        self.vae_tx = _adam(cfg.lr, opt_params)
        self.disc_tx = _adam(cfg.disc_lr, dp)
        self.state = VAETrainState(
            vae_params=vp, disc_params=dp,
            vae_opt=self.vae_tx.init(opt_params),
            disc_opt=self.disc_tx.init(dp), logvar=zero.clone(),
            lecam=LeCamEMA(zero.clone(), zero.clone()), step=0)

    def _step(self, state: VAETrainState, batch: torch.Tensor,
              eps: Optional[torch.Tensor]):
        cfg = self.cfg
        use_gan = state.step >= cfg.disc_start_step
        vp = {k: v.detach().requires_grad_(True)
              for k, v in state.vae_params.items()}
        logvar = state.logvar.detach().requires_grad_(True)
        gen = None if eps is not None else self.gen
        recon, mean, q_logvar = functional_call(self.vae, vp, (batch,),
                                                {"eps": eps,
                                                 "generator": gen})
        recon = recon[:, :batch.shape[1]]
        total, parts = vae_loss(recon, batch, mean, q_logvar, logvar,
                                lpips_fn=self.lpips_fn,
                                cfg=VAELossConfig(kl_weight=cfg.kl_weight))
        d_fake = functional_call(self.disc, state.disc_params, (recon,))
        gl = generator_loss(d_fake, cfg.gan_kind)
        if use_gan:
            total = total + cfg.disc_weight * gl
        grads = torch.autograd.grad(total, list(vp.values()) + [logvar])
        g_vae = dict(zip(vp, grads[:-1]))
        if cfg.logvar_in_adam:
            vae_params, vae_opt = self.vae_tx.update(
                {**g_vae, LOGVAR: grads[-1]}, state.vae_opt,
                {**state.vae_params, LOGVAR: state.logvar})
            new_logvar = vae_params.pop(LOGVAR)
        else:
            vae_params, vae_opt = self.vae_tx.update(g_vae, state.vae_opt,
                                                     state.vae_params)
            new_logvar = state.logvar - cfg.lr * grads[-1]

        dp = {k: v.detach().requires_grad_(True)
              for k, v in state.disc_params.items()}
        d_real = functional_call(self.disc, dp, (batch,))
        d_fake2 = functional_call(self.disc, dp, (recon.detach(),))
        dl = discriminator_loss(d_real, d_fake2, cfg.gan_kind)
        dl = dl + cfg.lecam_weight * lecam_reg(d_real, d_fake2, state.lecam)
        g_disc = dict(zip(dp, torch.autograd.grad(dl, list(dp.values()))))
        disc_new, disc_opt = self.disc_tx.update(g_disc, state.disc_opt,
                                                 state.disc_params)
        new = VAETrainState(
            vae_params=vae_params,
            disc_params=disc_new if use_gan else state.disc_params,
            vae_opt=vae_opt, disc_opt=disc_opt, logvar=new_logvar.detach(),
            lecam=state.lecam.update(d_real, d_fake2), step=state.step + 1)
        metrics = {"g_total": total, "nll": parts["nll"], "kl": parts["kl"],
                   "g_adv": gl, "d_loss": dl}
        return new, metrics

    def train_step(self, batch: torch.Tensor,
                   eps: Optional[torch.Tensor] = None) -> dict:
        """One G and one D update on ``batch`` [B,T,3,H,W] (moved to the
        trainer's device); ``eps`` is the latent noise (mean's shape),
        drawn from the trainer's generator when None. Returns the float
        metrics g_total, nll, kl, g_adv and d_loss."""
        batch = _on(batch, self.device)
        if eps is not None:
            eps = _on(eps, self.device)
        self.state, metrics = self._step(self.state, batch, eps)
        return {k: float(v.detach()) for k, v in metrics.items()}


def _on(a, device) -> torch.Tensor:
    if not isinstance(a, torch.Tensor):
        a = torch.from_numpy(np.array(a, np.float32))
    return a.to(device, torch.float32)
