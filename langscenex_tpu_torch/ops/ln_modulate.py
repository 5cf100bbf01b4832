"""Fused LayerNorm + adaLN modulation (CogVideoXLayerNormZero) — kernel K8.

Port of the JAX ``langscenex_tpu/ops/ln_modulate.py``. Per row of
``x [B, T, H]``: f32 mean and E[x²], var = max(E[x²] − mean², 0) (the
fast variance of flax's LayerNorm), n = (x − mean)·rsqrt(var + 1e-5),
then y = n·γ + β modulated per stream — rows ``< text_len`` take the
text (scale, shift), later rows the video pair:
y = (n·γ + β)(1 + scale) + shift.

:func:`ln_modulate` launches ``csrc/ln_modulate.cu`` (one read of x, one
write of y; bf16 or f32, one type for every operand, as the JAX kernel
reads each operand in its own type: the bf16 DiT serves and LoRA-trains
in bf16, the full fine-tune runs f32) or runs :func:`ln_modulate_plain`,
by ``_build``'s rule. It is an autograd function
whose backward differentiates the plain formula, as the JAX
``custom_vjp`` does.
"""
from __future__ import annotations

import torch

from .. import _build

EPS = 1e-5
# csrc/ln_modulate.cu holds a row in registers as 16-byte vectors: 4 per
# thread of its 128 in bf16, 8 in f32, so rows up to 4096 wide
MAX_WIDTH = 4096
KERNEL_DTYPES = (torch.bfloat16, torch.float32)


def ln_modulate_plain(x, gamma, beta, sc, sh, tsc, tsh, text_len: int):
    """The reference math (the JAX ``_lnz_ref``) in f32 on every operand:
    x [B,T,H]; gamma/beta [H]; sc/sh/tsc/tsh [B,H]. Returns x's dtype."""
    xf = x.float()
    s1 = xf.mean(-1, keepdim=True)
    s2 = (xf * xf).mean(-1, keepdim=True)
    inv = torch.rsqrt(torch.clamp(s2 - s1 * s1, min=0.0) + EPS)
    n = ((xf - s1) * inv) * gamma.float() + beta.float()
    nt = n[:, :text_len] * (1 + tsc.float()[:, None]) + tsh.float()[:, None]
    nv = n[:, text_len:] * (1 + sc.float()[:, None]) + sh.float()[:, None]
    return torch.cat([nt, nv], dim=1).to(x.dtype)


def _check(x, gamma, beta, mods) -> None:
    if x.dim() != 3:
        raise ValueError(f"ln_modulate wants x [B,T,H], got "
                         f"{tuple(x.shape)}")
    B, _, H = x.shape
    if gamma.shape != (H,) or beta.shape != (H,):
        raise ValueError("ln_modulate: gamma/beta must be [H]")
    for m in mods:
        if m.shape != (B, H):
            raise ValueError(f"ln_modulate: mods must be [B,H], got "
                             f"{tuple(m.shape)}")
    devs = {t.device for t in (x, gamma, beta, *mods)}
    if len(devs) != 1:
        raise ValueError(f"ln_modulate: operands on several devices {devs}")


def _ln_modulate_cuda(x, gamma, beta, sc, sh, tsc, tsh, text_len: int):
    """Launch K8: x, gamma, beta and mods of one dtype, bf16 or f32 -> y
    in that dtype."""
    B, T, H = x.shape
    ops = (x, gamma, beta, sc, sh, tsc, tsh)
    if x.dtype not in KERNEL_DTYPES or any(t.dtype != x.dtype for t in ops):
        raise TypeError(f"ln_modulate kernel wants every operand bf16 or "
                        f"every operand f32, got "
                        f"{sorted({str(t.dtype) for t in ops})}")
    vec = 16 // x.element_size()
    if H % vec or H > MAX_WIDTH:
        raise ValueError(f"ln_modulate kernel wants H % {vec} == 0 and "
                         f"H <= {MAX_WIDTH}, got {H}")
    x = x.contiguous()
    mods = [m.contiguous() for m in (sc, sh, tsc, tsh)]
    gamma, beta = gamma.contiguous(), beta.contiguous()
    if any(t.data_ptr() % 16 for t in (x, gamma, beta, *mods)):
        raise ValueError("ln_modulate kernel wants 16-byte aligned operands")
    y = torch.empty_like(x)
    _build.launch("ln_modulate", x.device, x.data_ptr(), gamma.data_ptr(),
                  beta.data_ptr(), *[m.data_ptr() for m in mods],
                  y.data_ptr(), B, T, H, int(text_len),
                  int(x.dtype == torch.float32))
    return y


class LnModulateFn(torch.autograd.Function):
    """K8 or the plain version forward, by ``_build``'s rule; backward
    through the plain formula (the JAX ``_lnz_vjp_bwd``)."""

    @staticmethod
    def forward(ctx, x, gamma, beta, sc, sh, tsc, tsh, text_len: int):
        ctx.save_for_backward(x, gamma, beta, sc, sh, tsc, tsh)
        ctx.text_len = text_len
        fn = _ln_modulate_cuda if _build.use_kernel(x) else ln_modulate_plain
        return fn(x, gamma, beta, sc, sh, tsc, tsh, text_len)

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(need)
                   for t, need in zip(saved, ctx.needs_input_grad)]
            y = ln_modulate_plain(*ins, ctx.text_len)
            wanted = [t for t in ins if t.requires_grad]
            grads = iter(torch.autograd.grad(y, wanted, g))
        return (*[next(grads) if t.requires_grad else None for t in ins],
                None)


def ln_modulate(x, gamma, beta, sc, sh, tsc, tsh, text_len: int):
    """Fused LNZ: LN(x)·γ + β then per-stream (1 + scale), shift.
    x [B,T,H]; gamma/beta [H]; sc/sh/tsc/tsh [B,H]. Kernel K8 (or an error
    for what it does not take) or the plain version, by ``_build``'s
    rule."""
    _check(x, gamma, beta, (sc, sh, tsc, tsh))
    return LnModulateFn.apply(x, gamma, beta, sc, sh, tsc, tsh,
                              int(text_len))
