"""Exact against bounded attention at the DiT's shape, [1, 48, 17776, 64]
bf16: the forward of the online softmax (K9) and of the no-max softmax
(K6), their agreement on the same inputs, and forward + backward of both
through K7, consuming dq, dk and dv.

    python -m langscenex_tpu_torch.experiments.ab_attention4 [--device cpu]
        [--iters 8] [--heads 48] [--tokens 17776]"""
from __future__ import annotations

import torch

from ..ops.flash_attention import flash_attention
from ..utils.device import resolve_device
from . import B, D, H, T, parse_args, report, seed_inputs, time_ms

KINDS = (("online-softmax (K9)", False), ("no-max (K6)", True))


def main(iters: int = 8, device=None, heads: int = H,
         tokens: int = T) -> dict:
    """Time both forwards and both forward + backward passes on seed-0
    inputs and compare the two forwards; returns {name: ms} and
    ``max_abs_diff``."""
    dev = resolve_device(device)
    q, k, v = seed_inputs(dev, heads, tokens)
    fwd = 4.0 * B * heads * tokens * tokens * D       # QK^T and PV
    bwd = 2.5 * fwd                                   # K7: s, dp, dv, dk, dq
    out = {}
    with torch.no_grad():
        for name, bounded in KINDS:
            out[f"fwd {name}"] = time_ms(
                lambda: flash_attention(q, k, v, bounded_logits=bounded),
                iters, dev)
            print(report(f"fwd {name}", out[f"fwd {name}"], fwd, dev),
                  flush=True)
        a = flash_attention(q, k, v, bounded_logits=False)
        b = flash_attention(q, k, v, bounded_logits=True)
        out["max_abs_diff"] = float((a.float() - b.float()).abs().max())
    print(f"no-max vs online max abs diff: {out['max_abs_diff']:.2e}",
          flush=True)
    del a, b
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    for name, bounded in KINDS:
        def step():
            o = flash_attention(*leaves, bounded_logits=bounded)
            grads = torch.autograd.grad((o.float() ** 2).sum(), leaves)
            # consume every gradient, as the JAX script does
            return sum(g[..., 0, :].float().sum() for g in grads)
        out[f"fwd+bwd {name}"] = time_ms(step, max(1, iters // 2), dev)
        print(report(f"fwd+bwd {name}", out[f"fwd+bwd {name}"], fwd + bwd,
                     dev), flush=True)
    return out


if __name__ == "__main__":
    a = parse_args(__doc__)
    main(a.iters, a.device, a.heads, a.tokens)
