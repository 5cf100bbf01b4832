"""Per-point Adam, port of the JAX ``train/per_point_adam.py``
(field_construction/scene/per_point_adam.py:5-100): Adam whose step for
each point row is scaled by its own learning-rate multiplier, which
self-adjusts every step by the sigmoid of the row's gradient magnitude
(lr_pp *= 0.99 + 0.02 * sigmoid(|g|)), plus the multipliers made from
CUT3R confidences (load_and_prepare_confidence, gaussian_field.py:85-107).

The update itself is ``GroupAdam.update`` of ``train/optim.py`` for the
group named by ``GroupAdam.per_point``: as in the JAX per-point Adam,
that group's schedule is evaluated at the count after the increment (the
other groups' at the count before it, as optax does).
"""
from __future__ import annotations

import torch


def adjust_per_point_lr(per_point_lr: torch.Tensor,
                        grad: torch.Tensor) -> torch.Tensor:
    """The multipliers [P,1] after one step with gradient ``grad`` [P,...]
    (_adjust_per_point_lr)."""
    gmag = torch.sqrt(torch.clamp(
        (grad.reshape(grad.shape[0], -1) ** 2).sum(-1), min=1e-24))
    scale = torch.where(gmag > 0, 0.99 + 0.02 * torch.sigmoid(gmag), 1.0)
    return per_point_lr * scale[:, None]


def confidence_lr(confidence: torch.Tensor, scale=(2.0, 100.0)
                  ) -> torch.Tensor:
    """CUT3R confidences -> per-point multipliers [P,1]: sigmoid, invert,
    scale into [lo, hi], so low-confidence points get a LARGE position
    rate (gaussian_field.py:85-107, called with (2, 100) at :131)."""
    inv = 1.0 - torch.sigmoid(confidence)
    lo, hi = scale
    return (inv * (hi - lo) + lo).reshape(-1, 1)
