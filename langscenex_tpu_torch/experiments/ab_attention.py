"""Attention A/B at the DiT's shape, [1, 48, 17776, 64] bf16: the
online-softmax forward K9 (``flash_attention``) against the natural-exp
head-pair forward K11 (``flash_attention_h2``).

    python -m langscenex_tpu_torch.experiments.ab_attention [--device cpu]
        [--iters 8] [--heads 48] [--tokens 17776]

The JAX script also swept flash_attention_h2's blocks (bq 512 and 1024,
bk 512 and 1024): those chose the TPU's VMEM tiles. Each kernel here has
one tile (128 queries by 128 keys), so each gets one line."""
from __future__ import annotations

import torch

from ..ops.flash_attention import flash_attention, flash_attention_h2
from ..utils.device import resolve_device
from . import B, D, H, T, parse_args, report, seed_inputs, time_ms


def main(iters: int = 8, device=None, heads: int = H,
         tokens: int = T) -> dict:
    """Time K9 and K11 on seed-0 inputs; returns {name: ms}."""
    dev = resolve_device(device)
    q, k, v = seed_inputs(dev, heads, tokens)
    flops = 4.0 * B * heads * tokens * tokens * D     # QK^T and PV
    runs = {"flash (K9, online softmax)": lambda: flash_attention(q, k, v),
            "h2 (K11, natural exp)": lambda: flash_attention_h2(q, k, v)}
    out = {}
    with torch.no_grad():
        for name, fn in runs.items():
            out[name] = time_ms(fn, iters, dev)
            print(report(name, out[name], flops, dev), flush=True)
    return out


if __name__ == "__main__":
    a = parse_args(__doc__)
    main(a.iters, a.device, a.heads, a.tokens)
