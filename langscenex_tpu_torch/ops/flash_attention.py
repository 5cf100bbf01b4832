"""Bounded-logit attention forward in the [B, T, H, D] layout — kernel K5.

Port of the forward that the JAX ``langscenex_tpu/ops/flash_attention.py``
runs for the CogVideoX DiT on one device: ``attention_bthd`` →
``_flash_bthd`` → ``_flash_fwd_impl_bthd`` → ``_attn_kernel_nomax_t4``.
The logits are bounded by the DiT's qk-LayerNorm, so there is no running
max, and the rounding points are the TPU kernel's: q is multiplied by
``scale·log2(e)`` in the working dtype, s = q'·kᵀ in f32, p = exp2(s) is
rounded to the working dtype before the PV product, the normalizer is the
sum of those rounded p, then l = max(l, 1e-30), o = acc / l and
l2 = log2(l) (kept for the backward, K7).

:func:`attention_bthd_kernel` launches kernel K5
(``csrc/flash_attention.cu``) and :func:`attention_bthd_plain` is its
plain version; both return ``(o, l2)``. :func:`attention_bthd` is the
model's entry point. On a CUDA tensor it launches K5 for every T, or
raises on a head dim or dtype the kernel does not take; its backward
raises until K7 is ported. Only this forward is ported:
``attention_auto``, the sequence- and tensor-parallel contexts and the
other attention kernels are not.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from .. import _build

LOG2E = 1.4426950408889634
KERNEL_HEAD_DIM = 64       # csrc/flash_attention.cu
PLAIN_Q_CHUNK = 256        # query rows per step of the plain version


def _scale2(scale: float, dtype: torch.dtype) -> torch.Tensor:
    """scale·log2(e) rounded to the working dtype, as the TPU kernel folds
    it (``jnp.asarray(scale2, q.dtype)``)."""
    return torch.tensor(scale * LOG2E, dtype=dtype)


def attention_bthd_plain(q, k, v, scale: float,
                         q_chunk: int = PLAIN_Q_CHUNK):
    """(o [B,T,H,D], l2 [B·H, T] f32) in q's dtype with the kernel's
    rounding points, one chunk of query rows at a time (so the full
    [B, H, T, T] logits are never held)."""
    B, T, H, D = q.shape
    dt = q.dtype
    s2 = _scale2(scale, dt).to(q.device)
    kf = k.permute(0, 2, 3, 1).float()                 # [B,H,D,Tk]
    vf = v.permute(0, 2, 1, 3).float()                 # [B,H,Tk,D]
    outs, l2s = [], []
    for lo in range(0, T, q_chunk):
        qc = (q[:, lo:lo + q_chunk] * s2).permute(0, 2, 1, 3).float()
        p = torch.exp2(torch.matmul(qc, kf)).to(dt).float()   # [B,H,c,Tk]
        l = p.sum(-1).clamp(min=1e-30)                       # [B,H,c]
        acc = torch.matmul(p, vf)                            # [B,H,c,D]
        del p
        outs.append((acc / l[..., None]).to(dt).permute(0, 2, 1, 3))
        l2s.append(torch.log2(l))
    o = torch.cat(outs, dim=1)
    l2 = torch.cat(l2s, dim=2).reshape(B * H, T)
    return o, l2


def _check(q, k, v) -> None:
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"attention_bthd wants q, k, v [B,T,H,D] of one "
                         f"shape, got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    devs = {q.device, k.device, v.device}
    if len(devs) != 1:
        raise ValueError(f"attention_bthd: operands on several devices "
                         f"{devs}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"attention_bthd: unsupported device {q.device}")


def _kernel_operand(t: torch.Tensor) -> torch.Tensor:
    """t itself when K5 can read it through its strides (head dim
    contiguous, 16-byte aligned rows), else a contiguous copy."""
    if (t.stride(3) == 1 and all(s % 8 == 0 for s in t.stride()[:3])
            and t.data_ptr() % 16 == 0):
        return t
    return t.contiguous()


def attention_bthd_kernel(q, k, v, scale: float):
    """Launch K5: q, k, v [B,T,H,64] bf16 on one CUDA device ->
    (o [B,T,H,64] bf16, l2 [B·H, T] f32)."""
    _check(q, k, v)
    B, T, H, D = q.shape
    if D != KERNEL_HEAD_DIM:
        raise ValueError(f"attention kernel K5 takes head_dim "
                         f"{KERNEL_HEAD_DIM}, got {D}")
    if any(t.dtype != torch.bfloat16 for t in (q, k, v)):
        raise TypeError(f"attention kernel K5 takes bf16, got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    if q.device.type != "cuda":
        raise ValueError(f"attention kernel K5 takes CUDA tensors, got "
                         f"{q.device}")
    q, k, v =(_kernel_operand(t) for t in (q, k, v))
    o = torch.empty((B, T, H, D), dtype=q.dtype, device=q.device)
    l2 = torch.empty((B * H, T), dtype=torch.float32, device=q.device)
    strides = [s for t in (q, k, v, o) for s in t.stride()[:3]]
    lib = _build.library()
    code = lib.lsx_flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        l2.data_ptr(), B, T, H, *strides, float(_scale2(scale,
                                                        torch.bfloat16)),
        _build.stream_ptr(q.device))
    _build.launch_counts["flash_attention"] += 1
    _build.check(code, "flash_attention")
    return o, l2


class FlashBTHDFn(torch.autograd.Function):
    """K5 forward on CUDA tensors; the backward is kernel K7, not ported
    yet."""

    @staticmethod
    def forward(ctx, q, k, v, scale: float):
        o, _ = attention_bthd_kernel(q, k, v, scale)
        return o

    @staticmethod
    def backward(ctx, do):
        raise NotImplementedError(
            "the attention backward is kernel K7 (langscenex_tpu/ops/"
            "flash_attention.py:360 _bwd_fused_kernel_t), not ported yet")


def attention_bthd(q, k, v, scale: Optional[float] = None,
                   dtype: torch.dtype = torch.bfloat16, plain: bool = False):
    """[B, T, H, D] non-causal attention for bounded logits. q, k, v are
    cast to ``dtype``; the output has q's dtype. K5 on CUDA tensors (it
    raises on a head dim or dtype it does not take, with no fallback), the
    plain version, differentiable by autograd, on CPU tensors or when the
    caller asks for it with ``plain=True`` (the DiT's plain path)."""
    _check(q, k, v)
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    out_dtype = q.dtype
    qd, kd, vd = q.to(dtype), k.to(dtype), v.to(dtype)
    if plain or q.device.type == "cpu":
        o, _ = attention_bthd_plain(qd, kd, vd, float(scale))
    else:
        o = FlashBTHDFn.apply(qd, kd, vd, float(scale))
    return o.to(out_dtype)
