"""Densification (clone / split / prune) on the fixed-capacity state with
its alive mask, port of the JAX ``train/densify.py``.

Parity target: gaussian_model.densify_and_prune / _split / _clone
(:612-718), mapped onto fixed capacity as in the JAX package:
  - clone: the source slot is untouched; one sampled copy is written to a
    free slot;
  - split (N=2): the source slot is overwritten with the sample at reduced
    scale and a copy is written to a free slot;
  - prune: the alive mask is cleared;
  - budget: the reference's max_all_points quantile capping plus the
    capacity bound (free slots);
  - the caller zeroes the Adam moments of every written slot.

The sampling noise is an argument (``noise`` [CAP, 3], standard normal):
the trainer draws it from a ``torch.Generator`` and the tests inject JAX's
``normal(key, (cap, 3))``. Shapes never change; free slots are taken in
index order.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..ops.quat import quat_normalize, quat_to_rotmat
from ..scene.gaussians import DensifyStats, GaussianState
from ..utils.config import OptimizationConfig


class DensifyResult(NamedTuple):
    state: GaussianState
    stats: DensifyStats
    written_slots: torch.Tensor   # [CAP] bool: slots whose moments reset
    n_cloned: torch.Tensor
    n_split: torch.Tensor
    n_pruned: torch.Tensor


def _cap_by_quantile(score: torch.Tensor, mask: torch.Tensor,
                     budget: torch.Tensor, n_ref: torch.Tensor
                     ) -> torch.Tensor:
    """If more than ``budget`` entries are selected, keep only scores above
    the (1 - budget / n_ref) quantile (linear interpolation), as
    gaussian_model.py:621-628. Scores outside ``mask`` are zeroed first."""
    masked = torch.where(mask, score, 0.0)
    need_cap = mask.sum() > budget
    ratio = torch.clamp(budget.float() / torch.clamp(n_ref.float(), min=1.0),
                        0.0, 1.0)
    thresh = torch.quantile(masked, 1.0 - ratio)
    return torch.where(need_cap, masked > thresh, mask)


@torch.no_grad()
def densify_and_prune(noise: torch.Tensor, state: GaussianState,
                      stats: DensifyStats, cfg: OptimizationConfig,
                      scene_extent: float,
                      size_threshold: float | None) -> DensifyResult:
    cap = state.capacity
    dev = state.device
    alive = state.alive
    n_alive = alive.sum().to(torch.int32)

    grads = torch.where(stats.denom > 0,
                        stats.xyz_gradient_accum / stats.denom, 0.0)
    grads_abs = torch.where(stats.denom_abs > 0,
                            stats.xyz_gradient_accum_abs / stats.denom_abs,
                            0.0)
    grads = torch.where(alive, grads, 0.0)
    grads_abs = torch.where(alive, grads_abs, 0.0)

    scales = state.get_scaling()
    max_scale = scales.max(-1).values
    pd_ext = cfg.percent_dense * scene_extent

    budget_total = torch.minimum(cfg.max_all_points - n_alive,
                                 cap - n_alive)

    # ---- clone selection (densify_and_clone :664-698)
    clone_mask = (alive & (grads >= cfg.densify_grad_threshold)
                  & (max_scale <= pd_ext))
    clone_mask = _cap_by_quantile(grads, clone_mask, budget_total, n_alive)

    # ---- split selection (densify_and_split :612-640)
    split_base = (alive & (grads >= cfg.densify_grad_threshold)
                  & (max_scale > pd_ext))
    split_mask = _cap_by_quantile(grads, split_base,
                                  budget_total - clone_mask.sum(), n_alive)
    if cfg.max_abs_split_points > 0:
        abs_ok = (alive & ~split_mask & (max_scale > pd_ext)
                  & (stats.max_radii2D > cfg.abs_split_radii2D_threshold)
                  & (grads_abs >= cfg.densify_abs_grad_threshold))
        abs_budget = torch.clamp(
            budget_total - clone_mask.sum() - split_mask.sum(),
            max=cfg.max_abs_split_points)
        split_mask = split_mask | _cap_by_quantile(grads_abs, abs_ok,
                                                   abs_budget, n_alive)

    new_mask = clone_mask | split_mask                 # each needs 1 slot

    # ---- free slots: dead slots in index order
    dead_order = torch.sort(alive.to(torch.int32), stable=True).indices
    n_dead = cap - n_alive
    rank = torch.cumsum(new_mask.to(torch.int64), 0) - 1
    has_slot = new_mask & (rank < n_dead)
    target = torch.where(has_slot, dead_order[torch.clamp(rank, 0, cap - 1)],
                         cap)

    # ---- new positions: x + R (eps * s)  (:641-647, :694-698)
    eps = noise * scales
    R = quat_to_rotmat(quat_normalize(state.rotation))
    new_xyz = state.xyz + (R * eps[:, None, :]).sum(-1)
    split_scaling = torch.log(torch.clamp(scales / (0.8 * 2), min=1e-12))
    new_scaling = torch.where(split_mask[:, None], split_scaling,
                              state.scaling)

    def scatter(dst, src):
        # dst[target[i]] = src[i] where target[i] < cap (row cap is a
        # scratch row that collects the rest and is dropped)
        out = torch.cat([dst, dst[:1]])
        out[target] = src
        return out[:cap]

    split_src = split_mask & has_slot
    xyz = scatter(state.xyz, new_xyz)
    scaling = scatter(state.scaling, new_scaling)
    ns = GaussianState(
        xyz=torch.where(split_src[:, None], new_xyz, xyz),
        knn_f=scatter(state.knn_f, state.knn_f),
        features_dc=scatter(state.features_dc, state.features_dc),
        features_rest=scatter(state.features_rest, state.features_rest),
        scaling=torch.where(split_src[:, None], split_scaling, scaling),
        rotation=scatter(state.rotation, state.rotation),
        opacity=scatter(state.opacity, state.opacity),
        language_feature=scatter(state.language_feature,
                                 state.language_feature),
        instance_feature=scatter(state.instance_feature,
                                 state.instance_feature),
        alive=scatter(state.alive, torch.ones_like(state.alive)))

    # ---- prune (densify_and_prune :700-718)
    prune = ns.alive & (torch.sigmoid(ns.opacity[:, 0])
                        < cfg.opacity_cull_threshold)
    if size_threshold is not None:
        # the reference zeroes max_radii2D before this check, so only the
        # world-size criterion is live (see the JAX module)
        big_ws = torch.exp(ns.scaling).max(-1).values > 0.1 * scene_extent
        prune = prune | (ns.alive & big_ws)
    written = scatter(torch.zeros(cap, dtype=torch.bool, device=dev),
                      torch.ones(cap, dtype=torch.bool, device=dev)) \
        | split_src
    ns = dataclasses.replace(ns, alive=ns.alive & ~prune)
    return DensifyResult(
        state=ns, stats=DensifyStats.zeros(cap, dev), written_slots=written,
        n_cloned=(clone_mask & has_slot).sum(), n_split=split_src.sum(),
        n_pruned=prune.sum())
