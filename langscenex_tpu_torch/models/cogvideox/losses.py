"""VAE and GAN losses for the 3D causal VAE fine-tune.

Port of the JAX ``langscenex_tpu/models/cogvideox/losses.py`` (the
reference's cogvideox_interpolation/losses.py): the reconstruction NLL
with a learned scalar output log-variance (optionally LPIPS-weighted) plus
KL, the hinge and vanilla (non-saturating) GAN losses, the LeCam
regularizer with its EMA of D's means, the R1 gradient penalty and the
adaptive generator weight. Every function takes and returns tensors;
``LeCamEMA.update`` reads its inputs without their graph.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import torch
import torch.nn.functional as F


# ----------------------------------------------------------------- VAE

def kl_divergence(mean: torch.Tensor, logvar: torch.Tensor) -> torch.Tensor:
    """KL(q || N(0,1)) summed per sample, mean over the batch."""
    kl = 0.5 * (mean ** 2 + torch.exp(logvar) - 1.0 - logvar)
    return kl.reshape(kl.shape[0], -1).sum(-1).mean()


@dataclasses.dataclass(frozen=True)
class VAELossConfig:
    kl_weight: float = 1e-6
    perceptual_weight: float = 1.0
    logvar_init: float = 0.0


def vae_loss(recon: torch.Tensor, target: torch.Tensor, mean: torch.Tensor,
             logvar_q: torch.Tensor, out_logvar: torch.Tensor,
             lpips_fn: Optional[Callable] = None,
             cfg: VAELossConfig = VAELossConfig()):
    """nll = (|x - x'| + w_p * lpips) / exp(logvar) + logvar, summed per
    sample and averaged, plus kl_weight * KL. ``out_logvar`` is the learned
    scalar output log-variance. Returns (total, {"nll", "kl"})."""
    rec = torch.abs(recon - target)
    if lpips_fn is not None and cfg.perceptual_weight > 0:
        rec = rec + cfg.perceptual_weight * lpips_fn(recon, target)
    nll = rec / torch.exp(out_logvar) + out_logvar
    nll = nll.reshape(nll.shape[0], -1).sum(-1).mean()
    kl = kl_divergence(mean, logvar_q)
    return nll + cfg.kl_weight * kl, {"nll": nll, "kl": kl}


# ----------------------------------------------------------------- GAN

class LeCamEMA(NamedTuple):
    """EMAs of the means of D(real) and D(fake) (scalar tensors)."""
    real: torch.Tensor
    fake: torch.Tensor
    decay: float = 0.999

    def update(self, d_real: torch.Tensor, d_fake: torch.Tensor
               ) -> "LeCamEMA":
        d = self.decay
        return LeCamEMA(real=d * self.real + (1 - d) * d_real.detach().mean(),
                        fake=d * self.fake + (1 - d) * d_fake.detach().mean(),
                        decay=d)


def lecam_reg(d_real: torch.Tensor, d_fake: torch.Tensor,
              ema: LeCamEMA) -> torch.Tensor:
    """Pull D's outputs toward the opposing EMA."""
    return (F.relu(d_real - ema.fake).pow(2).mean()
            + F.relu(ema.real - d_fake).pow(2).mean())


def discriminator_loss(d_real: torch.Tensor, d_fake: torch.Tensor,
                       kind: str = "hinge") -> torch.Tensor:
    if kind == "hinge":
        return F.relu(1.0 - d_real).mean() + F.relu(1.0 + d_fake).mean()
    return F.softplus(-d_real).mean() + F.softplus(d_fake).mean()


def generator_loss(d_fake: torch.Tensor, kind: str = "hinge") -> torch.Tensor:
    if kind == "hinge":
        return -d_fake.mean()
    return F.softplus(-d_fake).mean()


def r1_gradient_penalty(disc_fn: Callable, real: torch.Tensor
                        ) -> torch.Tensor:
    """E[||grad_x D(x)||^2] on real samples; the gradient of the sum (not
    the mean) of D, so each sample's is undiluted by the batch. Keeps the
    graph, so the penalty itself can be differentiated."""
    x = real.detach().requires_grad_(True)
    g, = torch.autograd.grad(disc_fn(x).sum(), x, create_graph=True)
    return g.pow(2).sum() / real.shape[0]


def adaptive_generator_weight(nll_grad_norm: torch.Tensor,
                              g_grad_norm: torch.Tensor,
                              max_weight: float = 1e4) -> torch.Tensor:
    """||grad nll|| / ||grad g_loss||, clipped to [0, max_weight], without
    its graph."""
    w = nll_grad_norm / (g_grad_norm + 1e-4)
    return torch.clamp(w, 0.0, max_weight).detach()
