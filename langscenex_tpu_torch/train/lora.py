"""LoRA for the DiT fine-tune path.

Port of the JAX ``train/lora.py``: low-rank adapters A·B added to
selected linears, gradients reaching only the adapters, a merge-free
adapted forward (:func:`lora_apply`: y = x@W + (α/r)·(x@A)@B in x's
dtype), :func:`merge_lora` and :func:`export_merged` to bake the adapters
into plain weights, and the train step. The adapters are a dict ``{site:
{"a": [in, r], "b": [r, out]}}`` of f32 tensors; the base weights are
frozen.

Sites follow the JAX model, whose attention has one fused,
per-head-interleaved ``to_qkv`` projection. The port keeps ``to_q``,
``to_k`` and ``to_v`` separate, so its ``attn1.to_qkv`` site is one
adapter over all three: a shared A [in, r] and a B [r, 3·hidden] whose
columns are q, k, v in the port's order (``convert.lora_from_numpy``
applies to B the de-interleave that ``cogvideox_dit_from_numpy`` applies
to the fused kernel). The adapter count and parameter count match the
JAX default (33,030,144 at full scale: 42 blocks × 786,432).
"""
from __future__ import annotations

import contextlib
import dataclasses
import re
from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn

from ..models.cogvideox.transformer import JointAttention
from .dit import (DiTTrainConfig, _sched_tables, diffusion_loss,
                  draw_t_noise, make_optimizer)

QKV = "to_qkv"      # the fused q/k/v site under each JointAttention


@dataclasses.dataclass(frozen=True)
class LoRAConfig:
    rank: int = 16
    alpha: float = 16.0
    # the JAX default targets: the attention projections (fused qkv and
    # out) and the MLP, in the port's module names
    target_patterns: Tuple[str, ...] = (
        r".*attn1\.to_qkv$", r".*attn1\.to_out\.0$", r".*ff\.net\.0\.proj$",
        r".*ff\.net\.2$")
    init_scale: float = 0.01


def _sites(model: nn.Module, cfg: LoRAConfig) -> Dict[str, Tuple[int, int]]:
    """{site: (in, out)} for every linear, and every attention's fused
    q/k/v, whose name matches a target pattern, in module order."""
    out = {}
    for name, m in model.named_modules():
        if isinstance(m, JointAttention):
            site = f"{name}.{QKV}"
            if any(re.match(p, site) for p in cfg.target_patterns):
                out[site] = (m.to_q.in_features, 3 * m.to_q.out_features)
        if isinstance(m, nn.Linear) and any(
                re.match(p, name) for p in cfg.target_patterns):
            out[name] = (m.in_features, m.out_features)
    return out


def init_lora(model: nn.Module, cfg: LoRAConfig,
              generator: Optional[torch.Generator] = None) -> Dict:
    """Adapters for every matched site: ``a`` random (normal ×
    init_scale), ``b`` zero, so the adapted model starts exactly at the
    base. f32, on the model's device."""
    dev = next(model.parameters()).device
    lora = {}
    for site, (kin, kout) in _sites(model, cfg).items():
        lora[site] = {
            "a": torch.randn((kin, cfg.rank), generator=generator,
                             device=dev) * cfg.init_scale,
            "b": torch.zeros((cfg.rank, kout), device=dev)}
    return lora


def n_params(lora: Dict) -> int:
    return sum(t.numel() for ab in lora.values() for t in ab.values())


def _delta(x: torch.Tensor, ab: Dict, scale: float) -> torch.Tensor:
    """(α/r)·(x@A)@B in x's dtype."""
    a, b = ab["a"].to(x.dtype), ab["b"].to(x.dtype)
    return torch.tensor(scale, dtype=x.dtype, device=x.device) * (x @ a @ b)


@contextlib.contextmanager
def adapted(model: nn.Module, lora: Dict, cfg: LoRAConfig):
    """While active, every adapted linear of ``model`` adds its adapter's
    delta to its output (forward hooks; they fire again when a remat
    block is recomputed). The fused q/k/v delta is computed once per
    attention call, before its projections, and split among them."""
    scale = cfg.alpha / cfg.rank
    modules = dict(model.named_modules())
    handles = []

    def add(ab):
        return lambda mod, args, y: y + _delta(args[0], ab, scale)

    def qkv_hooks(attn: JointAttention, ab):
        parts = {}

        def pre(mod, args):
            parts["qkv"] = list(_delta(args[0], ab, scale).chunk(3, dim=-1))

        def take(mod, args, y):
            return y + parts["qkv"].pop(0)
        return [attn.register_forward_pre_hook(pre)] + [
            getattr(attn, n).register_forward_hook(take)
            for n in ("to_q", "to_k", "to_v")]

    try:
        for site, ab in lora.items():
            if site.endswith("." + QKV):
                handles += qkv_hooks(modules[site[:-len(QKV) - 1]], ab)
            else:
                handles.append(modules[site].register_forward_hook(add(ab)))
        yield model
    finally:
        for h in handles:
            h.remove()


def lora_apply(model: nn.Module, lora: Dict, cfg: LoRAConfig, *args,
               **kwargs):
    """Merge-free adapted forward: ``model(*args, **kwargs)`` with
    y = x@W + (α/r)·(x@A)@B at every adapted site. The merged weights
    would be a full copy of the 11.1 GB base; the low-rank path adds only
    [T, r] activations."""
    with adapted(model, lora, cfg):
        return model(*args, **kwargs)


def merge_lora(state_dict: Dict, lora: Dict, cfg: LoRAConfig) -> Dict:
    """The base state_dict with W := W + (α/r)·(A@B)ᵀ at adapted sites
    (the delta in f32, cast to W's dtype); the fused q/k/v delta is split
    into to_q, to_k and to_v."""
    scale = cfg.alpha / cfg.rank
    out = dict(state_dict)
    for site, ab in lora.items():
        delta = (ab["a"].float() @ ab["b"].float()) * scale      # [in, out]
        if site.endswith("." + QKV):
            pre = site[:-len(QKV)]
            names = [f"{pre}{n}.weight" for n in ("to_q", "to_k", "to_v")]
            deltas = delta.chunk(3, dim=1)
        else:
            names, deltas = [f"{site}.weight"], [delta]
        for n, d in zip(names, deltas):
            w = out[n]
            out[n] = w + d.T.to(device=w.device, dtype=w.dtype)
    return out


def export_merged(state_dict: Dict, lora: Dict, cfg: LoRAConfig) -> Dict:
    """Adapters baked into a standalone state_dict on the CPU (inference
    needs no LoRA machinery afterwards)."""
    return {k: v.detach().cpu() for k, v in
            merge_lora(state_dict, lora, cfg).items()}


def _flat(lora: Dict) -> Dict[str, torch.Tensor]:
    return {f"{site}/{k}": t for site, ab in lora.items()
            for k, t in ab.items()}


def lora_loss_and_grads(model, lora: Dict, lora_cfg: LoRAConfig,
                        batch: Dict, t: torch.Tensor, noise: torch.Tensor,
                        tables) -> Tuple[torch.Tensor, Dict]:
    """The LoRA step's loss (the diffusion loss without min-SNR, through
    :func:`lora_apply`) and its gradients {site: {"a", "b"}}."""
    live = {site: {k: v.detach().requires_grad_() for k, v in ab.items()}
            for site, ab in lora.items()}
    flat = _flat(live)
    # the backward stays inside: remat blocks rerun their forward (and the
    # hooks) during it
    with adapted(model, live, lora_cfg):
        loss = diffusion_loss(model, batch, t, noise, tables)
        grads = dict(zip(flat, torch.autograd.grad(loss,
                                                   list(flat.values()))))
    return loss.detach(), {site: {k: grads[f"{site}/{k}"] for k in ab}
                           for site, ab in lora.items()}


def make_lora_train_step(model, cfg: DiTTrainConfig,
                         lora_cfg: LoRAConfig = LoRAConfig()):
    """LoRA variant of ``train.dit.make_dit_train_step``: the same batch
    contract and diffusion loss (without the min-SNR weight), with the
    optimizer state and gradients over the adapters only; ``model``'s own
    weights are the frozen base. Returns (init_state, step):
    ``init_state(generator=None)`` -> ``{"lora", "opt", "step"}`` and
    ``step(state, batch, generator=None, t=None, noise=None)`` -> (state,
    {"loss", "grad_norm"}), updating ``state`` in place."""
    opt = make_optimizer(cfg)
    model.requires_grad_(False)
    tables = _sched_tables(cfg, next(model.parameters()).device)

    def init_state(generator: Optional[torch.Generator] = None) -> Dict:
        lora = init_lora(model, lora_cfg, generator)
        return {"lora": lora, "opt": opt.init(_flat(lora)), "step": 0}

    def step(state: Dict, batch: Dict,
             generator: Optional[torch.Generator] = None,
             t: Optional[torch.Tensor] = None,
             noise: Optional[torch.Tensor] = None):
        if t is None or noise is None:
            t, noise = draw_t_noise(batch["x0"],
                                    cfg.sched.num_train_timesteps, generator)
        loss, grads = lora_loss_and_grads(model, state["lora"], lora_cfg,
                                          batch, t, noise, tables)
        gnorm = opt.update_(_flat(grads), state["opt"], _flat(state["lora"]))
        state["step"] += 1
        return state, {"loss": loss, "grad_norm": gnorm}

    return init_state, step
