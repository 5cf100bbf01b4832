"""Optimizers and learning-rate schedules for field construction, port of
the JAX ``train/optim.py``.

The JAX package runs one optax multi-group Adam over the splat parameter
dict (per-group learning rates, eps 1e-15, the xyz group on an
exponential schedule), plus small Adams for the camera poses and the
exposure table. This port writes that Adam as a functional update over a
dict of tensors that matches optax's arithmetic, instead of using
``torch.optim.Adam``, because the two differ where it matters here:

- a group frozen by the phase (``phase_grad_mask`` zeroes its gradient)
  still steps in optax: its decayed moments keep moving it, and its count
  advances. ``torch.optim.Adam`` skips a parameter whose ``.grad`` is
  None;
- optax evaluates the schedule at the count BEFORE the increment, bias
  corrects with t = count + 1 and divides by ``sqrt(nu_hat) + eps``;
- ``zero_moments_at`` resets the moments of the slots densification wrote,
  which needs the moments as plain tensors.

Schedules are evaluated in float32 with numpy, as the JAX step evaluates
them in f32 on the device.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import numpy as np
import torch

from ..scene.gaussians import GaussianState
from ..utils.config import OptimizationConfig

_F = np.float32


def expon_lr(step, lr_init: float, lr_final: float, lr_delay_steps: int = 0,
             lr_delay_mult: float = 1.0, max_steps: int = 1_000_000
             ) -> np.float32:
    """Log-linear lr decay with an optional delay ramp (JaxNeRF /
    Plenoxels), in float32."""
    if lr_init == 0.0 and lr_final == 0.0:
        return _F(0.0)
    t = np.clip(_F(step) / _F(max_steps), _F(0.0), _F(1.0))
    log_lerp = np.exp(np.log(_F(lr_init)) * (_F(1) - t)
                      + np.log(_F(lr_final)) * t)
    if lr_delay_steps > 0:
        delay_rate = _F(lr_delay_mult) + (_F(1) - _F(lr_delay_mult)) * np.sin(
            _F(0.5 * np.pi) * np.clip(_F(step) / _F(lr_delay_steps), 0, 1))
    else:
        delay_rate = _F(1.0)
    return _F(delay_rate * log_lerp)


# Trainable groups per phase (change_reqiures_grad semantics).
GEOMETRY_GROUPS = ("xyz", "knn_f", "features_dc", "features_rest",
                   "scaling", "rotation", "opacity")
PHASE_MASKS = {
    "semantic": GEOMETRY_GROUPS + ("language_feature",),
    "semantic_only": ("language_feature",),
    "instance": ("instance_feature",),
    "geometry": GEOMETRY_GROUPS,
    "finetune": ("features_dc", "features_rest"),
}

# The differentiated splat parameters (GaussianState minus ``alive``).
PARAM_FIELDS = ("xyz", "knn_f", "features_dc", "features_rest", "scaling",
                "rotation", "opacity", "language_feature", "instance_feature")


def group_lrs(cfg: OptimizationConfig, spatial_lr_scale: float) -> dict:
    """Static per-group lrs (xyz is scheduled separately)."""
    return {
        "xyz": cfg.position_lr_init * spatial_lr_scale,
        "knn_f": cfg.knn_f_lr,
        "features_dc": cfg.feature_lr,
        "features_rest": cfg.feature_lr / 20.0,
        "opacity": cfg.opacity_lr,
        "scaling": cfg.scaling_lr,
        "rotation": cfg.rotation_lr,
        "language_feature": cfg.language_feature_lr,
        "instance_feature": cfg.instance_feature_lr,
    }


def splat_params(state: GaussianState) -> dict:
    return {f: getattr(state, f) for f in PARAM_FIELDS}


@dataclasses.dataclass
class AdamState:
    """optax ``ScaleByAdamState`` per group: one count (all groups of an
    optimizer step together) and the first and second moments."""
    count: int
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class GroupAdam:
    """Adam over a dict of tensors with a learning rate per group;
    ``lr_fn(count)`` gives the dict of rates for the step at ``count``."""
    lr_fn: Callable[[int], dict]
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8

    def init(self, params: dict) -> AdamState:
        return AdamState(
            count=0, mu={k: torch.zeros_like(v) for k, v in params.items()},
            nu={k: torch.zeros_like(v) for k, v in params.items()})

    @torch.no_grad()
    def update(self, grads: dict, state: AdamState, params: dict):
        """One optax-equivalent step: returns (new params, new state)."""
        lrs = self.lr_fn(state.count)
        t = _F(state.count + 1)
        bc1 = float(_F(1) - _F(self.b1) ** t)
        bc2 = float(_F(1) - _F(self.b2) ** t)
        new_p, mu, nu = {}, {}, {}
        for k, p in params.items():
            g = grads[k]
            mu[k] = (1 - self.b1) * g + self.b1 * state.mu[k]
            nu[k] = (1 - self.b2) * (g * g) + self.b2 * state.nu[k]
            upd = (mu[k] / bc1) / (torch.sqrt(nu[k] / bc2) + self.eps)
            new_p[k] = p + float(-lrs[k]) * upd
        return new_p, AdamState(count=state.count + 1, mu=mu, nu=nu)


def make_splat_optimizer(cfg: OptimizationConfig,
                         spatial_lr_scale: float) -> GroupAdam:
    """Adam(eps=1e-15) with a learning rate per group over the splat
    parameter dict; xyz follows the exponential position schedule.
    ``pp_optimizer`` (per-point Adam) is not ported yet."""
    if cfg.pp_optimizer:
        raise NotImplementedError("the per-point Adam (pp_optimizer) is "
                                  "not ported")
    lrs = group_lrs(cfg, spatial_lr_scale)

    def lr_fn(count):
        out = dict(lrs)
        out["xyz"] = expon_lr(count, cfg.position_lr_init * spatial_lr_scale,
                              cfg.position_lr_final * spatial_lr_scale,
                              lr_delay_mult=cfg.position_lr_delay_mult,
                              max_steps=cfg.position_lr_max_steps)
        return out
    return GroupAdam(lr_fn=lr_fn, eps=1e-15)


def make_pose_optimizer(cfg: OptimizationConfig) -> GroupAdam:
    """Camera pose Adam with the cam scheduler (gaussian_model.py:331-340):
    rotation_lr * 0.1 -> rotation_lr * 0.001 over cfg.iterations."""
    def lr_fn(count):
        return {"poses": expon_lr(count, cfg.rotation_lr * 0.1,
                                  cfg.rotation_lr * 0.001,
                                  lr_delay_mult=cfg.position_lr_delay_mult,
                                  max_steps=cfg.iterations)}
    return GroupAdam(lr_fn=lr_fn, eps=1e-15)


def make_app_optimizer() -> GroupAdam:
    """Exposure affine optimizer (scene/app_model.py:16-18)."""
    return GroupAdam(lr_fn=lambda count: {"app_ab": 0.001}, b2=0.99)


def phase_grad_mask(phase: str, grads: dict) -> dict:
    """Zero the gradients of groups frozen in ``phase``."""
    active = set(PHASE_MASKS[phase])
    return {name: (g if name in active else torch.zeros_like(g))
            for name, g in grads.items()}


def zero_moments_at(state: AdamState, slot_mask: torch.Tensor) -> AdamState:
    """Reset the Adam moments at slots where ``slot_mask`` is True — the
    fixed-capacity analogue of the reference's cat_tensors_to_optimizer
    zero-extension (gaussian_model.py:561-581)."""
    cap = slot_mask.shape[0]

    def reset(leaf):
        if leaf.ndim >= 1 and leaf.shape[0] == cap:
            m = slot_mask.reshape((cap,) + (1,) * (leaf.ndim - 1))
            return torch.where(m, torch.zeros_like(leaf), leaf)
        return leaf
    return AdamState(count=state.count,
                     mu={k: reset(v) for k, v in state.mu.items()},
                     nu={k: reset(v) for k, v in state.nu.items()})
