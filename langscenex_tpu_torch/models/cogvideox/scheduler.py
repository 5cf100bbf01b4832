"""Diffusion schedulers: CogVideoX-style DDIM (v-prediction, zero-SNR
rescaled betas) and DPM-Solver++(2M).

Port of the JAX ``langscenex_tpu/models/cogvideox/scheduler.py``:
scaled_linear betas in [0.00085, 0.012] over 1000 train steps, the
CogVideoX SNR shift, the zero-SNR terminal rescale and "trailing"
timestep spacing. The alphas are computed in numpy exactly as there and
held as an f32 tensor; the updates run in f32 on the sample's device.
Timesteps are Python ints (the denoise loop is a Python loop).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    beta_schedule: str = "scaled_linear"
    prediction_type: str = "v_prediction"
    rescale_betas_zero_snr: bool = True
    timestep_spacing: str = "trailing"
    set_alpha_to_one: bool = True
    snr_shift_scale: float = 3.0    # CogVideoX SNR shift


def _alphas_cumprod(cfg: SchedulerConfig) -> np.ndarray:
    if cfg.beta_schedule == "scaled_linear":
        betas = np.linspace(cfg.beta_start ** 0.5, cfg.beta_end ** 0.5,
                            cfg.num_train_timesteps) ** 2
    elif cfg.beta_schedule == "linear":
        betas = np.linspace(cfg.beta_start, cfg.beta_end,
                            cfg.num_train_timesteps)
    else:
        raise ValueError(cfg.beta_schedule)
    alphas = 1.0 - betas
    ac = np.cumprod(alphas)
    # CogVideoX SNR shift (scheduling_ddim_cogvideox): ac' = ac/(s - (s-1)ac)
    s = cfg.snr_shift_scale
    ac = ac / (s - (s - 1.0) * ac)
    if cfg.rescale_betas_zero_snr:
        # shift + scale sqrt(ac) so the terminal step has zero SNR
        sq = np.sqrt(ac)
        sq0, sqT = sq[0].copy(), sq[-1].copy()
        sq = sq - sqT
        sq = sq * sq0 / (sq0 - sqT)
        ac = sq ** 2
    return ac.astype(np.float32)


class DDIMScheduler:
    """Deterministic DDIM with v-prediction (eta = 0, as the pipeline
    uses)."""

    def __init__(self, cfg: SchedulerConfig = SchedulerConfig()):
        self.cfg = cfg
        self.alphas_cumprod = torch.from_numpy(_alphas_cumprod(cfg))
        self._tables = {}          # device -> alphas_cumprod there
        self.final_alpha_cumprod = (1.0 if cfg.set_alpha_to_one
                                    else float(self.alphas_cumprod[0]))

    def timesteps(self, num_inference_steps: int) -> list[int]:
        T = self.cfg.num_train_timesteps
        if self.cfg.timestep_spacing == "trailing":
            step = T / num_inference_steps
            ts = np.arange(T, 0, -step).round().astype(np.int64) - 1
        elif self.cfg.timestep_spacing == "linspace":
            ts = np.linspace(0, T - 1, num_inference_steps
                             ).round().astype(np.int64)[::-1]
        else:  # leading
            step = T // num_inference_steps
            ts = (np.arange(num_inference_steps) * step).round()[::-1]
        return [int(t) for t in ts]

    def _alpha(self, t, like: torch.Tensor) -> torch.Tensor:
        """alphas_cumprod[t] as an f32 tensor on ``like``'s device, shaped
        to broadcast against it (t an int, or a [B] tensor)."""
        table = self._tables.get(like.device)
        if table is None:
            table = self._tables[like.device] = self.alphas_cumprod.to(
                like.device)
        a = table[t if isinstance(t, int)
                  else torch.as_tensor(t, device=like.device)]
        while a.dim() < like.dim() and a.dim() > 0:
            a = a[..., None]
        return a

    def _prev_alpha(self, t_prev: int, like: torch.Tensor) -> torch.Tensor:
        if t_prev >= 0:
            return self._alpha(t_prev, like)
        return torch.tensor(self.final_alpha_cumprod, dtype=torch.float32,
                            device=like.device)

    def _pred_x0_eps(self, model_out, sample, t):
        a_t = self._alpha(t, sample)
        sqrt_a = torch.sqrt(a_t)
        sqrt_1ma = torch.sqrt(1.0 - a_t)
        if self.cfg.prediction_type == "v_prediction":
            x0 = sqrt_a * sample - sqrt_1ma * model_out
            eps = sqrt_a * model_out + sqrt_1ma * sample
        elif self.cfg.prediction_type == "epsilon":
            eps = model_out
            x0 = (sample - sqrt_1ma * eps) / sqrt_a
        else:  # sample
            x0 = model_out
            eps = (sample - sqrt_a * x0) / sqrt_1ma
        return x0, eps

    def step(self, model_out: torch.Tensor, t: int, t_prev: int,
             sample: torch.Tensor) -> torch.Tensor:
        """One deterministic DDIM update from t to t_prev (t_prev < 0 is
        the final step, alpha = final_alpha_cumprod)."""
        x0, eps = self._pred_x0_eps(model_out, sample, t)
        a_prev = self._prev_alpha(t_prev, sample)
        return torch.sqrt(a_prev) * x0 + torch.sqrt(1.0 - a_prev) * eps

    def add_noise(self, x0: torch.Tensor, noise: torch.Tensor,
                  t) -> torch.Tensor:
        a = self._alpha(t, x0)
        return torch.sqrt(a) * x0 + torch.sqrt(1.0 - a) * noise

    def get_velocity(self, x0: torch.Tensor, noise: torch.Tensor,
                     t) -> torch.Tensor:
        a = self._alpha(t, x0)
        return torch.sqrt(a) * noise - torch.sqrt(1.0 - a) * x0


class DPMState(NamedTuple):
    prev_model_out: torch.Tensor   # D_{i-1} (x0-space), zeros before step 1
    has_prev: bool


class DPMSolverScheduler(DDIMScheduler):
    """DPM-Solver++(2M) multistep in x0 space (the CogVideoXDPMScheduler
    alternative). Deterministic."""

    def init_state(self, shape, device=None) -> DPMState:
        return DPMState(prev_model_out=torch.zeros(shape, device=device),
                        has_prev=False)

    @staticmethod
    def _lambda(a):
        return 0.5 * torch.log(a / (1.0 - a))

    def step_dpm(self, state: DPMState, model_out, t: int, t_prev: int,
                 t_next: int, sample):
        """2M update t -> t_prev (t_next is the step after t_prev, or -1;
        the JAX update does not read it). Returns (sample, state)."""
        x0, _ = self._pred_x0_eps(model_out, sample, t)
        a_t = torch.clamp(self._alpha(t, sample), 1e-8, 1.0 - 1e-8)
        a_s = torch.clamp(self._prev_alpha(t_prev, sample), 1e-8, 1.0 - 1e-8)
        h = self._lambda(a_s) - self._lambda(a_t)
        sigma_t = torch.sqrt(1 - a_t)
        sigma_s = torch.sqrt(1 - a_s)
        alpha_s = torch.sqrt(a_s)
        if state.has_prev:
            d1 = x0 - state.prev_model_out
            new = ((sigma_s / sigma_t) * sample
                   - alpha_s * torch.expm1(-h) * x0
                   - 0.5 * alpha_s * torch.expm1(-h) * d1)
        else:
            new = (sigma_s / sigma_t) * sample - alpha_s * torch.expm1(-h) * x0
        return new, DPMState(prev_model_out=x0, has_prev=True)
