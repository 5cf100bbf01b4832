"""TriMap DiT fine-tune trainer (v-prediction diffusion loss).

Port of the JAX ``train/dit.py``: the v-prediction target from the
CogVideoX schedule (``scheduler._alphas_cumprod``), the conditioning
latents concatenated on channels as the interpolation pipeline does at
inference, the squared error in f32 with an optional min-SNR-γ weight,
one train step with a global-norm clip and AdamW on a warmup-cosine
schedule, an optional EMA of the parameters, and ``fit``. Set
``TransformerConfig(remat=True)`` to recompute blocks in the backward.

The optimizer equals optax's ``chain(clip_by_global_norm(max_norm),
adamw(warmup_cosine_decay_schedule(0, lr, warmup, max(total,
warmup + 1))))`` step for step: the clip scales g by max_norm / ‖g‖ only
when ‖g‖ ≥ max_norm; the moments and their bias correction are optax's;
weight decay wd·p is added after the Adam scaling on every leaf; the
learning rate is read at the count before the increment, so it is 0 at
step 0. It updates the parameters and moments in place (the JAX step
donates its state instead), so a full-width step holds one copy of each.

The state is ``{"params": {name: parameter}, "opt": {"count", "mu",
"nu"}, "step": int}`` plus ``"ema"`` when enabled; its params are the
model's own parameters. The step draws t and the noise from a
``torch.Generator`` (the JAX step from its key) unless they are given.

Parallel steps over a ``parallel.mesh`` (one process per rank):
``make_dit_train_step`` of a tensor-parallel shard (``parallel.mesh.
sharded_dit``) sums the partial gradients of ``norm_q``/``norm_k`` over
``model`` and clips by the norm of the whole model (the sharded leaves'
squares summed over ``model``, the replicated ones counted once), so
each rank's update is its part of the unsharded step's.
``make_parallel_dit_train_step`` adds data parallelism: every rank draws
t and the noise for the global batch from one generator, takes its rows
on ``data`` and averages the gradients over ``data`` — the global-batch
step, as ``jax.random`` over the global batch makes the JAX package's
sharded step equal its single-device one.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Optional

import numpy as np
import torch

from ..models.cogvideox.scheduler import SchedulerConfig, _alphas_cumprod
from ..parallel.mesh import (Mesh, param_kind, reduce_gradients_,
                             reduce_mean_, shard_batch_tree,
                             sharded_global_norm)

_F = np.float32


@dataclasses.dataclass(frozen=True)
class DiTTrainConfig:
    lr: float = 1e-5
    weight_decay: float = 1e-4
    betas: tuple = (0.9, 0.95)
    eps: float = 1e-8
    max_grad_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_snr_gamma: Optional[float] = None   # e.g. 5.0; None = plain MSE
    ema_decay: Optional[float] = None       # e.g. 0.9999; None = off
    sched: SchedulerConfig = SchedulerConfig()


def warmup_cosine_lr(count: int, cfg: DiTTrainConfig) -> np.float32:
    """optax ``warmup_cosine_decay_schedule(0, lr, warmup, max(total,
    warmup + 1))`` at ``count``, in float32: a linear ramp from 0 over the
    warmup, then a cosine decay to 0."""
    warm = cfg.warmup_steps
    if count < warm:
        frac = _F(1) - _F(count) / _F(warm)
        return _F(_F(0.0 - cfg.lr) * frac + _F(cfg.lr))
    decay = _F(max(cfg.total_steps, warm + 1) - warm)
    c = min(_F(count - warm), decay)
    cos = _F(0.5) * (_F(1) + np.cos(_F(np.pi) * c / decay, dtype=_F))
    return _F(_F(cfg.lr) * cos)


@dataclasses.dataclass(frozen=True)
class AdamW:
    """The optimizer of :func:`make_optimizer`, over a dict of tensors."""
    cfg: DiTTrainConfig

    def init(self, params: dict) -> dict:
        return {"count": 0,
                "mu": {k: torch.zeros_like(p) for k, p in params.items()},
                "nu": {k: torch.zeros_like(p) for k, p in params.items()}}

    @torch.no_grad()
    def update_(self, grads: dict, state: dict, params: dict,
                gnorm: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One step in place on ``params`` and ``state``; returns the raw
        global norm of ``grads`` (which it may scale in place), or clips by
        ``gnorm`` when given (a sharded model's whole-model norm)."""
        cfg = self.cfg
        b1, b2 = cfg.betas
        if gnorm is None:
            gnorm = global_norm(grads)
        if not bool(gnorm < cfg.max_grad_norm):
            for g in grads.values():
                g.div_(gnorm).mul_(cfg.max_grad_norm)
        lr = warmup_cosine_lr(state["count"], cfg)
        t = _F(state["count"] + 1)
        bc1 = float(_F(1) - _F(b1) ** t)
        bc2 = float(_F(1) - _F(b2) ** t)
        for k, p in params.items():
            g, mu, nu = grads[k], state["mu"][k], state["nu"][k]
            mu.mul_(b1).add_(g, alpha=1 - b1)
            nu.mul_(b2).addcmul_(g, g, value=1 - b2)
            upd = (mu / bc1).div_((nu / bc2).sqrt_().add_(cfg.eps))
            upd.add_(p, alpha=cfg.weight_decay)
            p.add_(upd, alpha=-float(lr))
        state["count"] += 1
        return gnorm


def make_optimizer(cfg: DiTTrainConfig) -> AdamW:
    return AdamW(cfg)


def global_norm(tree: dict) -> torch.Tensor:
    """sqrt of the sum of squares over every leaf, in f32 (optax)."""
    return torch.sqrt(sum((g.float() ** 2).sum() for g in tree.values()))


def _sched_tables(cfg: DiTTrainConfig, device):
    ac = torch.from_numpy(_alphas_cumprod(cfg.sched)).to(device)
    return ac, torch.sqrt(ac), torch.sqrt(1.0 - ac)


def diffusion_loss(model, batch: dict, t: torch.Tensor, noise: torch.Tensor,
                   tables, min_snr_gamma: Optional[float] = None
                   ) -> torch.Tensor:
    """The v-prediction loss of one batch at timesteps t [B] with the
    given noise: noisy = √ᾱ·x0 + √(1−ᾱ)·noise, the model on [noisy; cond]
    (channel concat), target √ᾱ·noise − √(1−ᾱ)·x0, squared error in f32
    averaged per sample, weighted by min(SNR, γ)/SNR when γ is given."""
    ac, sqrt_ac, sqrt_1m = tables
    x0 = batch["x0"]
    a = sqrt_ac[t][:, None, None, None, None].to(x0.dtype)
    b = sqrt_1m[t][:, None, None, None, None].to(x0.dtype)
    noisy = a * x0 + b * noise
    model_in = torch.cat([noisy, batch["cond"]], dim=2)
    v_pred = model(model_in, batch["text"], t)
    v_tgt = a * noise - b * x0
    per = (v_pred - v_tgt).float().square().mean(dim=(1, 2, 3, 4))
    if min_snr_gamma is not None:
        snr = ac[t] / torch.clamp(1.0 - ac[t], min=1e-8)
        per = per * (torch.clamp(snr, max=min_snr_gamma)
                     / torch.clamp(snr, min=1e-8))
    return per.mean()


def draw_t_noise(x0: torch.Tensor, num_train_timesteps: int,
                 generator: Optional[torch.Generator]):
    """Timesteps [B] uniform in [0, T) and standard-normal noise of x0's
    shape and dtype, in that order from ``generator``."""
    t = torch.randint(0, num_train_timesteps, (x0.shape[0],),
                      generator=generator, device=x0.device)
    noise = torch.randn(x0.shape, generator=generator, dtype=x0.dtype,
                        device=x0.device)
    return t, noise


def _bind(model, params: dict) -> dict:
    """The model's parameters by name, after copying in those of
    ``params`` that are other tensors (a restored or converted state)."""
    own = dict(model.named_parameters())
    if own.keys() != params.keys():
        raise KeyError(f"state params differ from the model's: "
                       f"{sorted(own.keys() ^ params.keys())[:5]}")
    with torch.no_grad():
        for k, p in own.items():
            if params[k] is not p:
                p.copy_(params[k])
    return own


def finish_gradients(grads: dict, kinds: Optional[dict], model,
                     dp: Optional[Mesh]) -> Optional[torch.Tensor]:
    """The parallel steps' gradient reductions, in place: partial
    gradients summed over the sharded ``model``'s ``model`` axis, then all
    of them averaged over ``dp``'s ``data`` axis. Returns the whole
    model's global norm for a sharded model, else None (the optimizer
    then takes the plain one)."""
    tp = getattr(model, "tp", None)
    reduce_gradients_(grads, kinds, tp, dp)
    return sharded_global_norm(grads, kinds, tp) if tp is not None else None


def make_dit_train_step(model, cfg: DiTTrainConfig = DiTTrainConfig()):
    """Returns (init_state, step) for a full fine-tune of ``model`` (the
    DiT, or one rank's tensor-parallel shard of it).

    ``init_state(params=None)`` loads ``params`` ({name: tensor}) into the
    model when given, and starts the optimizer (and EMA) from the model's
    parameters. ``step(state, batch, generator=None, t=None, noise=None)
    -> (state, metrics)`` updates ``state`` in place; ``batch`` holds
      x0    [B,F,C,H,W]  clean video latents (VAE-encoded, scaled)
      cond  [B,F,C,H,W]  conditioning latents (first/last-frame pad)
      text  [B,L,text_dim]
    and metrics are ``loss`` and ``grad_norm`` (of the raw gradients)."""
    return _train_step(model, cfg, None)


def make_parallel_dit_train_step(model, mesh: Mesh,
                                 cfg: DiTTrainConfig = DiTTrainConfig()):
    """:func:`make_dit_train_step` over ``mesh``'s ``data`` axis (and, for a
    sharded ``model``, tensor-parallel over its ``model`` axis): ``step``
    takes the global batch, draws t and the noise for it from
    ``generator`` (the same on every rank), runs this rank's rows and
    averages the gradients and the loss over ``data``."""
    tp = getattr(model, "tp", None)
    if tp is not None and tp is not mesh:
        raise ValueError("make_parallel_dit_train_step: the model is "
                         "another mesh's shard")
    return _train_step(model, cfg, mesh)


def _train_step(model, cfg: DiTTrainConfig, mesh: Optional[Mesh]):
    opt = make_optimizer(cfg)
    model.requires_grad_(True)
    tables = _sched_tables(cfg, next(model.parameters()).device)

    def init_state(params: Optional[dict] = None) -> dict:
        own = _bind(model, params if params is not None
                    else dict(model.named_parameters()))
        state = {"params": own, "opt": opt.init(own), "step": 0}
        if cfg.ema_decay is not None:
            state["ema"] = {k: p.detach().clone() for k, p in own.items()}
        return state

    def step(state: dict, batch: dict,
             generator: Optional[torch.Generator] = None,
             t: Optional[torch.Tensor] = None,
             noise: Optional[torch.Tensor] = None):
        params = state["params"] = _bind(model, state["params"])
        if t is None or noise is None:
            t, noise = draw_t_noise(batch["x0"],
                                    cfg.sched.num_train_timesteps, generator)
        if mesh is not None:
            batch, t, noise = shard_batch_tree((batch, t, noise), mesh)
        loss = diffusion_loss(model, batch, t, noise, tables,
                              cfg.min_snr_gamma)
        grads = dict(zip(params, torch.autograd.grad(
            loss, list(params.values()))))
        loss = reduce_mean_(loss, mesh)
        kinds = {k: param_kind(k) for k in grads}
        gnorm = opt.update_(grads, state["opt"], params,
                            finish_gradients(grads, kinds, model, mesh))
        del grads
        if cfg.ema_decay is not None:
            d = cfg.ema_decay
            with torch.no_grad():
                for k, e in state["ema"].items():
                    e.mul_(d).add_(params[k], alpha=1.0 - d)
        state["step"] += 1
        return state, {"loss": loss.detach(), "grad_norm": gnorm}

    return init_state, step


def fit(model, batches: Iterable[dict],
        cfg: DiTTrainConfig = DiTTrainConfig(),
        generator: Optional[torch.Generator] = None, log_every: int = 50):
    """Minimal fine-tune loop over an iterable of batch dicts; returns the
    state and the metrics of every ``log_every``-th step."""
    init_state, step = make_dit_train_step(model, cfg)
    state = init_state()
    history = []
    for i, batch in enumerate(batches):
        state, metrics = step(state, batch, generator)
        if i % log_every == 0:
            history.append({k: float(v) for k, v in metrics.items()})
    return state, history
