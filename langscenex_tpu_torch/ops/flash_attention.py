"""Bounded-logit attention in the [B, T, H, D] layout — kernels K5
(forward) and K7 (backward).

Port of what the JAX ``langscenex_tpu/ops/flash_attention.py`` runs for
the CogVideoX DiT on one device: ``attention_bthd`` → ``_flash_bthd``,
whose forward is ``_flash_fwd_impl_bthd`` → ``_attn_kernel_nomax_t4``
and whose backward rule ``_flash_bthd_bwd_rule`` → ``_flash_bwd_core``
→ ``_bwd_fused_kernel_t`` (the fused branch).
The logits are bounded by the DiT's qk-LayerNorm, so there is no running
max, and the rounding points are the TPU kernel's: q is multiplied by
``scale·log2(e)`` in the working dtype, s = q'·kᵀ in f32, p = exp2(s) is
rounded to the working dtype before the PV product, the normalizer is the
sum of those rounded p, then l = max(l, 1e-30), o = acc / l and
l2 = log2(l) (kept for the backward, K7).

The backward recomputes p = exp2(s − l2) from the saved l2 with the TPU
kernel's rounding points: ds = p·(dp − dvec) rounded to the working
dtype, dvec = Σ_d do·o in f32, dv = Σ_q p̃·do with p̃ = p in the working
dtype, dk = Σ_q ds·q' / log2(e), dq = scale·Σ_k ds·k.

:func:`attention_bthd_kernel` launches K5 (``csrc/flash_attention.cu``)
and :func:`attention_bthd_plain` is its plain version; both return
``(o, l2)``. :func:`attention_bthd_backward_kernel` launches K7
(``csrc/flash_attention_backward.cu``) and
:func:`attention_bthd_backward_plain` is its plain version; both return
``(dq, dk, dv)``. :func:`attention_bthd` is the model's entry point, an
autograd function (:class:`FlashBTHDFn`) over K5 and K7 on CUDA tensors
(it raises on a head dim or dtype they do not take) and over the plain
versions on CPU tensors or when the caller asks for them. Only these are
ported: ``attention_auto``, the sequence- and tensor-parallel contexts
and the other attention kernels are not.
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


def attention_bthd_backward_plain(q, k, v, o, l2, do, scale: float,
                                  q_chunk: int = PLAIN_Q_CHUNK):
    """(dq, dk, dv) [B,T,H,D] in q's dtype from the forward's q, k, v, o,
    l2 [B·H, T] f32 and the output gradient do, with K7's rounding points,
    one chunk of query rows at a time (so no [B, H, T, T] array is
    held)."""
    B, T, H, D = q.shape
    dt = q.dtype
    s2 = _scale2(scale, dt).to(q.device)
    kf = k.permute(0, 2, 1, 3).float()                 # [B,H,Tk,D]
    vf = v.permute(0, 2, 1, 3).float()
    dvec = (do.float() * o.float()).sum(-1).permute(0, 2, 1)   # [B,H,T]
    l2 = l2.reshape(B, H, T)
    dk = torch.zeros_like(kf)
    dv = torch.zeros_like(vf)
    dqs = []
    for lo in range(0, T, q_chunk):
        hi = min(lo + q_chunk, T)
        qc = (q[:, lo:hi] * s2).permute(0, 2, 1, 3).float()   # [B,H,c,D]
        doc = do[:, lo:hi].permute(0, 2, 1, 3).float()
        p = torch.exp2(torch.matmul(qc, kf.transpose(-1, -2))
                       - l2[..., lo:hi, None])                 # [B,H,c,Tk]
        dp = torch.matmul(doc, vf.transpose(-1, -2))
        ds = (p * (dp - dvec[..., lo:hi, None])).to(dt).float()
        del dp
        dv += torch.matmul(p.to(dt).float().transpose(-1, -2), doc)
        del p
        dk += torch.matmul(ds.transpose(-1, -2), qc)
        dqs.append((torch.matmul(ds, kf) * scale).to(dt))
    dq = torch.cat(dqs, dim=2).permute(0, 2, 1, 3)
    dk = (dk * (1.0 / LOG2E)).to(dt).permute(0, 2, 1, 3)
    return dq, dk, dv.to(dt).permute(0, 2, 1, 3)


def attention_bthd_backward_kernel(q, k, v, o, l2, do, scale: float):
    """Launch K7: q, k, v, o and do [B,T,H,64] bf16 and l2 [B·H, T] f32
    (from K5) on one CUDA device -> (dq, dk, dv) [B,T,H,64] bf16. dq is
    summed with f32 atomics into a zeroed scratch that is then cast."""
    _check(q, k, v)
    B, T, H, D = q.shape
    if D != KERNEL_HEAD_DIM:
        raise ValueError(f"attention kernel K7 takes head_dim "
                         f"{KERNEL_HEAD_DIM}, got {D}")
    if any(t.dtype != torch.bfloat16 for t in (q, k, v, o, do)):
        raise TypeError(f"attention kernel K7 takes bf16, got "
                        f"{[str(t.dtype) for t in (q, k, v, o, do)]}")
    if l2 is None or l2.dtype != torch.float32 or l2.shape != (B * H, T):
        raise ValueError(f"attention kernel K7 needs the forward's l2 "
                         f"[{B * H}, {T}] f32, got "
                         f"{None if l2 is None else (tuple(l2.shape), l2.dtype)}")
    if o.shape != q.shape or do.shape != q.shape:
        raise ValueError("attention kernel K7 wants o and do of q's shape")
    if any(t.device != q.device for t in (o, l2, do)) or (
            q.device.type != "cuda"):
        raise ValueError(f"attention kernel K7 takes CUDA tensors on one "
                         f"device, got {q.device}")
    # q' = bf16(q · bf16(scale·log2 e)) and dvec = Σ_d do·o in f32, as the
    # JAX package forms them in XLA around its kernel
    qs = q * _scale2(scale, q.dtype).to(q.device)
    dvec = (do.float() * o.float()).sum(-1).permute(0, 2, 1).contiguous()
    k, v, do = (_kernel_operand(t) for t in (k, v, do))
    l2 = l2.contiguous()
    dq = torch.zeros((B, T, H, D), dtype=torch.float32, device=q.device)
    dk = torch.empty((B, T, H, D), dtype=q.dtype, device=q.device)
    dv = torch.empty((B, T, H, D), dtype=q.dtype, device=q.device)
    strides = [s for t in (qs, k, v, do) for s in t.stride()[:3]]
    code = _build.library().lsx_flash_attention_bwd(
        qs.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        l2.data_ptr(), dvec.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), B, T, H, *strides, float(scale),
        _build.stream_ptr(q.device))
    _build.launch_counts["flash_attention_backward"] += 1
    _build.check(code, "flash_attention_backward")
    return dq.to(q.dtype), dk, dv


class FlashBTHDFn(torch.autograd.Function):
    """Attention with K5 forward and K7 backward on CUDA tensors, the
    plain versions on CPU tensors or with ``plain=True``. Saves q, k, v,
    o and l2 for the backward, as the JAX custom_vjp does."""

    @staticmethod
    def forward(ctx, q, k, v, scale: float, plain: bool):
        use_plain = plain or q.device.type == "cpu"
        fwd = attention_bthd_plain if use_plain else attention_bthd_kernel
        o, l2 = fwd(q, k, v, scale)
        ctx.save_for_backward(q, k, v, o, l2)
        ctx.scale, ctx.use_plain = scale, use_plain
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, l2 = ctx.saved_tensors
        bwd = (attention_bthd_backward_plain if ctx.use_plain
               else attention_bthd_backward_kernel)
        dq, dk, dv = bwd(q, k, v, o, l2, do, ctx.scale)
        return dq, dk, dv, None, None


def attention_bthd(q, k, v, scale: Optional[float] = None,
                   dtype: torch.dtype = torch.bfloat16, plain: bool = False):
    """[B, T, H, D] non-causal attention for bounded logits. q, k, v are
    cast to ``dtype``; the output has q's dtype, and its gradient reaches
    the backward in ``dtype``. K5 forward and K7 backward on CUDA tensors
    (they raise on a head dim or dtype they do not take, with no
    fallback), the plain versions on CPU tensors or when the caller asks
    for them with ``plain=True`` (the DiT's plain path)."""
    _check(q, k, v)
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    out_dtype = q.dtype
    qd, kd, vd = q.to(dtype), k.to(dtype), v.to(dtype)
    o = FlashBTHDFn.apply(qd, kd, vd, float(scale), bool(plain))
    return o.to(out_dtype)
