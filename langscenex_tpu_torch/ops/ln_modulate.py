"""Fused LayerNorm + adaLN modulation (CogVideoXLayerNormZero) — kernel K8.

Port of the JAX ``langscenex_tpu/ops/ln_modulate.py``. Per row of
``x [B, T, H]``: f32 mean and E[x²], var = max(E[x²] − mean², 0) (the
fast variance of flax's LayerNorm), n = (x − mean)·rsqrt(var + 1e-5),
then y = n·γ + β modulated per stream — rows ``< text_len`` take the
text (scale, shift), later rows the video pair:
y = (n·γ + β)(1 + scale) + shift.

:func:`ln_modulate` launches ``csrc/ln_modulate.cu`` on CUDA tensors
(one read of x, one write of y) and runs :func:`ln_modulate_plain` on
CPU tensors. It is an autograd function whose backward differentiates
the plain formula, as the JAX ``custom_vjp`` does.
"""
from __future__ import annotations

import torch

from .. import _build

EPS = 1e-5
THREADS = 128            # csrc/ln_modulate.cu
MAX_VEC_PER_THREAD = 4   # 16-byte vectors each thread holds in registers


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
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"ln_modulate: unsupported device {x.device}")


def _ln_modulate_cuda(x, gamma, beta, sc, sh, tsc, tsh, text_len: int):
    """Launch K8: bf16 x, gamma, beta and mods -> bf16 y."""
    B, T, H = x.shape
    if any(t.dtype != torch.bfloat16 for t in (x, gamma, beta, sc, sh, tsc,
                                               tsh)):
        raise TypeError(f"ln_modulate kernel wants bf16 operands, got "
                        f"{[str(t.dtype) for t in (x, gamma, sc)]}")
    if H % 8 or H > 8 * THREADS * MAX_VEC_PER_THREAD:
        raise ValueError(f"ln_modulate kernel wants H % 8 == 0 and "
                         f"H <= {8 * THREADS * MAX_VEC_PER_THREAD}, got {H}")
    x = x.contiguous()
    mods = [m.contiguous() for m in (sc, sh, tsc, tsh)]
    gamma, beta = gamma.contiguous(), beta.contiguous()
    if any(t.data_ptr() % 16 for t in (x, gamma, beta, *mods)):
        raise ValueError("ln_modulate kernel wants 16-byte aligned operands")
    y = torch.empty_like(x)
    lib = _build.library()
    code = lib.lsx_ln_modulate(
        x.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
        *[m.data_ptr() for m in mods], y.data_ptr(), B, T, H, int(text_len),
        _build.stream_ptr(x.device))
    _build.launch_counts["ln_modulate"] += 1
    _build.check(code, "ln_modulate")
    return y


class LnModulateFn(torch.autograd.Function):
    """K8 (or the plain version on CPU tensors) forward; backward through
    the plain formula (the JAX ``_lnz_vjp_bwd``)."""

    @staticmethod
    def forward(ctx, x, gamma, beta, sc, sh, tsc, tsh, text_len: int):
        ctx.save_for_backward(x, gamma, beta, sc, sh, tsc, tsh)
        ctx.text_len = text_len
        if x.device.type == "cpu":
            return ln_modulate_plain(x, gamma, beta, sc, sh, tsc, tsh,
                                     text_len)
        return _ln_modulate_cuda(x, gamma, beta, sc, sh, tsc, tsh, text_len)

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
    x [B,T,H]; gamma/beta [H]; sc/sh/tsc/tsh [B,H]. Kernel K8 on CUDA
    tensors (or an error for what it does not take), the plain version on
    CPU tensors."""
    _check(x, gamma, beta, (sc, sh, tsc, tsh))
    return LnModulateFn.apply(x, gamma, beta, sc, sh, tsc, tsh,
                              int(text_len))
