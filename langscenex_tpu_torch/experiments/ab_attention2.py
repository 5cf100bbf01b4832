"""exp2-domain attention forwards against the online softmax at the DiT's
shape, [1, 48, T, 64] bf16: K9 (``flash_attention``), K13a
(``flash_exp2``: exp2 in f32, the normalizer summed from the unrounded p)
and K13b (``flash_exp2_bf16``: p = exp2(bf16(s − m)) in packed bf16), at
T = 17,776 (the DiT's tokens, a masked key tail) and 18,432 (a whole
number of 1024-key blocks, no mask).

    python -m langscenex_tpu_torch.experiments.ab_attention2 [--device cpu]
        [--iters 8] [--heads 48] [--tokens 17776 18432] [--block 1024]

The JAX script's probes ``flash_exp2`` and ``flash_exp2_bf16`` keep their
signatures here. Their ``block_q`` and ``block_k`` are the TPU kernels'
VMEM tiles; on the card each kernel has one tile (128 queries by 128
keys), and they choose only the plain version's key block on the CPU. The
JAX script also timed K9 with a 2048-query block ("bq2048"), a TPU tile
with no counterpart here, so that row is left out. It never ran
``flash_exp2_bf16`` (its second ``__main__`` block is ``and False``),
which runs here at each T that is a whole number of blocks and is refused
at the others: there JAX's grid of T // block drops the last keys and
leaves the last rows unwritten."""
from __future__ import annotations

import math

import torch

from .. import _build
from ..ops.flash_attention import (_check_bhtd, flash_attention,
                                   flash_attention_exp2_bf16_kernel,
                                   flash_attention_exp2_bf16_plain,
                                   flash_attention_exp2_kernel,
                                   flash_attention_exp2_plain)
from ..utils.device import resolve_device
from . import B, D, H, parse_args, report, seed_inputs, time_ms

TOKENS = (17776, 18432)      # masked (not a multiple of 64) and mask-free
BLOCK = 1024                 # the JAX probes' default block_q and block_k


def flash_exp2(q, k, v, block_q: int = BLOCK, block_k: int = BLOCK):
    """JAX's ``flash_exp2``: q [B,H,T,D], k, v [B,H,Tk,D] -> o [B,H,T,D]
    with scale 1/√D folded into q with log2 e in q's dtype, keys past Tk
    masked before the max, the normalizer summed from the unrounded p. By
    ``_build``'s rule K13a (bf16, D = 64) or the plain version at JAX's
    key block min(block_k, Tk)."""
    _check_bhtd(q, k, v)
    scale = 1.0 / math.sqrt(q.shape[-1])
    if not _build.use_kernel(q):
        return flash_attention_exp2_plain(q, k, v, scale, block_k=block_k)
    return flash_attention_exp2_kernel(q, k, v, scale)


def flash_exp2_bf16(q, k, v, block_q: int = BLOCK, block_k: int = BLOCK):
    """JAX's ``flash_exp2_bf16``: ``flash_exp2`` with p = exp2(bf16(s − m))
    in bf16 and the normalizer summed from those p. JAX's grid covers
    T // block of each axis and takes Tk = T, so a ValueError is raised
    unless both blocks divide T and Tk == T (JAX would drop the last keys
    and leave the last rows unwritten). By ``_build``'s rule K13b or the
    plain version at ``block_k``."""
    _check_bhtd(q, k, v)
    T, Tk = q.shape[2], k.shape[2]
    if Tk != T or T % block_q or T % block_k:
        raise ValueError(f"flash_exp2_bf16 takes Tk == T and T a multiple of "
                         f"block_q and block_k, got T {T}, Tk {Tk}, blocks "
                         f"{block_q}, {block_k}")
    scale = 1.0 / math.sqrt(q.shape[-1])
    if not _build.use_kernel(q):
        return flash_attention_exp2_bf16_plain(q, k, v, scale,
                                               block_k=block_k)
    return flash_attention_exp2_bf16_kernel(q, k, v, scale)


def main(iters: int = 8, device=None, heads: int = H, tokens=TOKENS,
         block: int = BLOCK) -> dict:
    """Time K9, K13a and (where ``block`` divides T) K13b on seed-0 inputs
    at each length of ``tokens``; returns {name: ms}."""
    dev = resolve_device(device)
    out = {}
    for T in tokens:
        q, k, v = seed_inputs(dev, heads, T)
        flops = 4.0 * B * heads * T * T * D           # QK^T and PV
        tail = "masked" if T % 64 else "mask-free"
        runs = {f"current T={T} ({tail}, K9)": lambda: flash_attention(
                    q, k, v),
                f"exp2 T={T} ({tail}, K13a)": lambda: flash_exp2(
                    q, k, v, block, block)}
        if T % block == 0:
            runs[f"exp2 bf16 T={T} ({tail}, K13b)"] = lambda: flash_exp2_bf16(
                q, k, v, block, block)
        with torch.no_grad():
            for name, fn in runs.items():
                out[name] = time_ms(fn, iters, dev)
                print(report(name, out[name], flops, dev), flush=True)
        if T % block:
            print(f"{f'exp2 bf16 T={T}':40s} refused: T is not a multiple "
                  f"of the {block}-key block", flush=True)
        del q, k, v
    return out


if __name__ == "__main__":
    a = parse_args(__doc__, tokens=TOKENS, block=BLOCK)
    main(a.iters, a.device, a.heads, tuple(a.tokens), a.block)
