"""Attention — kernels K5, K6, K9, K11 and K13a/b (forward) and K7
(backward) — and the attention dispatch of the DiT.

Port of ``langscenex_tpu/ops/flash_attention.py``:

* on one device, ``attention_bthd`` → ``_flash_bthd``, whose forward is
  ``_flash_fwd_impl_bthd`` → ``_attn_kernel_nomax_t4`` (K5, [B, T, H, D])
  and whose backward rule ``_flash_bthd_bwd_rule`` → ``_flash_bwd_core``
  → ``_bwd_fused_kernel_t`` (K7, the fused branch);
* for a tensor-parallel shard (``tensor_parallel=True``, the JAX
  package's ``tensor_parallel`` context, which the shard's attention
  passes itself), ``attention_bthd`` hands [B, H, T, D] views to
  ``attention_auto``, which runs ``flash_attention(
  bounded_logits=True)`` → ``_flash_fwd_impl_t`` →
  ``_attn_kernel_nomax_t`` (K6, [B, H, T, D], key length Tk that may
  differ from T) with K7 as its backward;
* ``flash_attention(bounded_logits=False)``, the JAX default, and
  ``attention_auto`` with it → ``_flash_fwd_impl`` → ``_attn_kernel``
  (K9, the online softmax) with the split backward kernels
  ``_bwd_dq_kernel``/``_bwd_dkv_kernel`` (K12), which compute K7's
  function from K9's l2, so K7's kernel serves them;
* ``flash_attention_h2`` → ``_attn_kernel_h2`` (K11), forward only;
* the exp2 probes of ``experiments/ab_attention2.py``, ``flash_exp2`` →
  ``_exp2_kernel`` (K13a) and ``flash_exp2_bf16`` → ``_exp2_bf16_kernel``
  (K13b), forward only, which the port's
  ``experiments/ab_attention2.py`` calls through the wrappers here.

The bounded forward (K5, K6): the logits are bounded by the DiT's
qk-LayerNorm, so there is no running max, and the rounding points are
the TPU kernels': q is multiplied by ``scale·log2(e)`` in the working
dtype, s = q'·kᵀ in f32, p = exp2(s) is rounded to the working dtype
before the PV product, the normalizer is the sum of those rounded p over
the valid keys, then l = max(l, 1e-30), o = acc / l and l2 = log2(l)
(kept for the backward, K7).

The online forward (K9) has the same q' and s, and per block of keys a
running row max m (from -1e30): m' = max(m, rowmax s), p = exp2(s − m'),
acc = acc·exp2(m − m') + bf16(p)·v and l = l·exp2(m − m') + Σ bf16(p);
o = acc / max(l, 1e-30) and l2 = m + log2 max(l, 1e-30). Where the
rescales fall moves bf16(p) at rounding level, so its plain version takes
the block: JAX's default 1024 on the CPU, the kernel's 64-key tile where
it is held against the kernel. K11 is the same recurrence in the
natural-exp domain: q scaled by bf16(scale), p = exp(s − m'), l summed
from the unrounded p, bf16(p) in the PV product, no l2. K13a is K9's
recurrence with l summed from the unrounded p, and no l2; K13b is K13a
with p = exp2(bf16(s − m')) evaluated in bf16 (the kernel two at a time,
packed), l summed from those bf16 p, the rescale exp2(m − m') in f32.

The backward recomputes p = exp2(s − l2) from the saved l2 with the TPU
kernel's rounding points: ds = p·(dp − dvec) rounded to the working
dtype, dvec = Σ_d do·o in f32, dv = Σ_q p̃·do with p̃ = p in the working
dtype, dk = Σ_q ds·q' / log2(e), dq = scale·Σ_k ds·k.

Each kernel has a wrapper that launches it on CUDA tensors and raises on
what it does not take, and a plain version that the wrappers never fall
back to: :func:`attention_bthd_kernel` / :func:`attention_bthd_plain`
(K5), :func:`flash_attention_kernel` / :func:`flash_attention_plain`
(K6), :func:`flash_attention_online_kernel` /
:func:`flash_attention_online_plain` (K9),
:func:`flash_attention_h2_kernel` / :func:`flash_attention_h2_plain`
(K11), :func:`flash_attention_exp2_kernel` /
:func:`flash_attention_exp2_plain` (K13a),
:func:`flash_attention_exp2_bf16_kernel` /
:func:`flash_attention_exp2_bf16_plain` (K13b),
:func:`attention_bthd_backward_kernel` /
:func:`attention_bthd_backward_plain` and, on [B, H, T, D] views of the
same kernel, :func:`flash_attention_backward_kernel` /
:func:`flash_attention_backward_plain` (K7). :class:`FlashBTHDFn`,
:class:`FlashFn` and :class:`OnlineFn` are the autograd functions of the
bounded [B, T, H, D], bounded [B, H, T, D] and online [B, H, T, D]
attention: the kernels on CUDA tensors, the plain versions on CPU
tensors or when the caller asks for them. The sequence-parallel ring is
not ported.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from .. import _build

LOG2E = 1.4426950408889634
NEG_INF = -1e30            # the online softmax's initial max (JAX's NEG_INF)
KERNEL_HEAD_DIM = 64       # csrc/flash_attention.cu
KERNEL_BLOCK_K = 64        # keys per tile of the forward kernels
KERNEL_Q_TILE = 64         # queries per step of K7
KERNEL_BWD_KEYS = 128      # keys per block of K7
ONLINE_BLOCK_K = 1024      # JAX's default key block of K9
H2_BLOCK_K = 512           # JAX's default key block of K11
EXP2_BLOCK_K = 1024        # JAX's default key block of K13a/b
PLAIN_Q_CHUNK = 256        # query rows per step of the plain version


def _scale2(scale: float, dtype: torch.dtype) -> torch.Tensor:
    """scale·log2(e) rounded to the working dtype, as the TPU kernel folds
    it (``jnp.asarray(scale2, q.dtype)``)."""
    return torch.tensor(scale * LOG2E, dtype=dtype)


def _bthd(t: torch.Tensor) -> torch.Tensor:
    """The [B, T, H, D] view of a [B, H, T, D] tensor, and back."""
    return t.transpose(1, 2)


def flash_attention_plain(q, k, v, scale: float,
                          q_chunk: int = PLAIN_Q_CHUNK):
    """K6's plain version: q [B,H,T,D], k, v [B,H,Tk,D] -> (o [B,H,T,D]
    in q's dtype, l2 [B·H, T] f32) with the kernel's rounding points, one
    chunk of query rows at a time (so the full [B, H, T, Tk] logits are
    never held)."""
    B, H, T, D = q.shape
    dt = q.dtype
    s2 = _scale2(scale, dt).to(q.device)
    kf = k.transpose(-1, -2).float()                   # [B,H,D,Tk]
    vf = v.float()                                     # [B,H,Tk,D]
    outs, l2s = [], []
    for lo in range(0, T, q_chunk):
        qc = (q[:, :, lo:lo + q_chunk] * s2).float()
        p = torch.exp2(torch.matmul(qc, kf)).to(dt).float()   # [B,H,c,Tk]
        l = p.sum(-1).clamp(min=1e-30)                       # [B,H,c]
        acc = torch.matmul(p, vf)                            # [B,H,c,D]
        del p
        outs.append((acc / l[..., None]).to(dt))
        l2s.append(torch.log2(l))
    o = torch.cat(outs, dim=2)
    l2 = torch.cat(l2s, dim=2).reshape(B * H, T)
    return o, l2


def attention_bthd_plain(q, k, v, scale: float,
                         q_chunk: int = PLAIN_Q_CHUNK):
    """K5's plain version: (o [B,T,H,D], l2 [B·H, T] f32) in q's dtype
    from q, k, v [B,T,H,D]; :func:`flash_attention_plain` on the
    [B, H, T, D] views."""
    o, l2 = flash_attention_plain(_bthd(q), _bthd(k), _bthd(v), scale,
                                  q_chunk)
    return _bthd(o), l2


def _online_plain(q, k, v, q_scale: torch.Tensor, block_k: int, q_chunk: int,
                  mode: str):
    """The online softmax over key blocks of ``block_k``, one chunk of
    query rows at a time: (o in q's dtype, m [B,H,T], l [B,H,T] f32).

    The running max m_j after block j is the cumulative max of the block
    maxima (from NEG_INF); block j's p is exp(s − m_j) (exp2 but in the
    ``"natural"`` mode), and the recurrence acc_j = acc_{j-1}·exp(m_{j-1} −
    m_j) + p̃_j·v is summed at once as Σ_j exp(m_j − m_last)·p̃_j·v, equal
    up to f32 rounding. p̃ is bf16(p) (p rounded to q's dtype), or in the
    ``"exp2_bf16"`` mode exp2(bf16(s − m_j)) in bf16. l sums p̃ (``"online"``,
    ``"exp2_bf16"``) or the unrounded p (``"natural"``, ``"exp2"``). Keys
    past Tk (the pad of the last block) take NEG_INF."""
    B, H, T, D = q.shape
    Tk = k.shape[2]
    dt = q.dtype
    exp = torch.exp if mode == "natural" else torch.exp2
    bk = min(block_k, Tk)
    nb = -(-Tk // bk)
    kf = k.transpose(-1, -2).float()                   # [B,H,D,Tk]
    vf = v.float()                                     # [B,H,Tk,D]
    outs, ms, ls = [], [], []
    for lo in range(0, T, q_chunk):
        qc = (q[:, :, lo:lo + q_chunk] * q_scale).float()
        s = torch.nn.functional.pad(torch.matmul(qc, kf), (0, nb * bk - Tk),
                                    value=NEG_INF).unflatten(-1, (nb, bk))
        m = s.amax(-1).clamp(min=NEG_INF).cummax(-1).values   # [B,H,c,nb]
        s -= m[..., None]                              # d = s − m_j
        if mode == "exp2_bf16":
            p = pr = exp(s.to(torch.bfloat16).float()).to(
                torch.bfloat16).float()                # [B,H,c,nb,bk]
        else:
            p = exp(s)
            pr = p.to(dt).float()
        del s
        w = exp(m - m[..., -1:])                       # rescale to m_last
        l = ((p if mode in ("natural", "exp2") else pr).sum(-1) * w).sum(-1)
        del p
        acc = torch.matmul((pr * w[..., None]).flatten(-2)[..., :Tk], vf)
        del pr
        outs.append((acc / l.clamp(min=1e-30)[..., None]).to(dt))
        ms.append(m[..., -1])
        ls.append(l)
    return torch.cat(outs, 2), torch.cat(ms, 2), torch.cat(ls, 2)


def flash_attention_online_plain(q, k, v, scale: float,
                                 block_k: int = ONLINE_BLOCK_K,
                                 q_chunk: int = PLAIN_Q_CHUNK):
    """K9's plain version: q [B,H,T,D], k, v [B,H,Tk,D] -> (o [B,H,T,D] in
    q's dtype, l2 [B·H, T] f32 = m + log2 max(l, 1e-30)), with JAX's
    rounding points and its rescale after every ``block_k`` keys (JAX's
    default block by default; the kernel's tile is ``KERNEL_BLOCK_K``)."""
    B, H, T, _ = q.shape
    o, m, l = _online_plain(q, k, v, _scale2(scale, q.dtype).to(q.device),
                            block_k, q_chunk, "online")
    return o, (m + torch.log2(l.clamp(min=1e-30))).reshape(B * H, T)


def flash_attention_h2_plain(q, k, v, scale: float,
                             block_k: int = H2_BLOCK_K,
                             q_chunk: int = PLAIN_Q_CHUNK):
    """K11's plain version: q [B,H,T,D], k, v [B,H,Tk,D] -> o [B,H,T,D] in
    q's dtype. q is scaled by ``scale`` in its dtype, p = exp(s − m) per
    block of ``block_k`` keys (JAX's 512 by default), the normalizer sums
    the unrounded p and the PV product takes bf16(p)."""
    q_scale = torch.tensor(scale, dtype=q.dtype, device=q.device)
    return _online_plain(q, k, v, q_scale, block_k, q_chunk, "natural")[0]


def flash_attention_exp2_plain(q, k, v, scale: float,
                               block_k: int = EXP2_BLOCK_K,
                               q_chunk: int = PLAIN_Q_CHUNK):
    """K13a's plain version: q [B,H,T,D], k, v [B,H,Tk,D] -> o [B,H,T,D] in
    q's dtype. K9's q', s and running max per block of ``block_k`` keys
    (JAX's 1024 by default; the kernel's tile is ``KERNEL_BLOCK_K``), the
    normalizer summed from the unrounded p, bf16(p) in the PV product."""
    return _online_plain(q, k, v, _scale2(scale, q.dtype).to(q.device),
                         block_k, q_chunk, "exp2")[0]


def flash_attention_exp2_bf16_plain(q, k, v, scale: float,
                                    block_k: int = EXP2_BLOCK_K,
                                    q_chunk: int = PLAIN_Q_CHUNK):
    """K13b's plain version: K13a's, with p = exp2(bf16(s − m)) computed in
    f32 and rounded to bf16, the normalizer summed from those bf16 p. This
    is exp2 itself, as the TPU's native exp2 and the card's packed one
    compute it; JAX's interpret mode lowers the exp2 of a bf16 operand to
    exp(bf16(ln 2)·x) instead (``tests/test_torch_attention_exp2.py``)."""
    return _online_plain(q, k, v, _scale2(scale, q.dtype).to(q.device),
                         block_k, q_chunk, "exp2_bf16")[0]


def _check(q, k, v) -> None:
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"attention_bthd wants q, k, v [B,T,H,D] of one "
                         f"shape, got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    _check_devices(q, k, v)


def _check_bthd_kv(q, k, v) -> None:
    B, _, H, D = q.shape if q.dim() == 4 else (None,) * 4
    if (q.dim() != 4 or k.dim() != 4 or k.shape != v.shape
            or (k.shape[0], k.shape[2], k.shape[3]) != (B, H, D)):
        raise ValueError(f"attention wants q [B,T,H,D] and k, v [B,Tk,H,D], "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    _check_devices(q, k, v)


def _check_bhtd(q, k, v) -> None:
    B, H, _, D = q.shape if q.dim() == 4 else (None,) * 4
    if (q.dim() != 4 or k.dim() != 4 or k.shape != v.shape
            or (k.shape[0], k.shape[1], k.shape[3]) != (B, H, D)):
        raise ValueError(f"flash_attention wants q [B,H,T,D] and k, v "
                         f"[B,H,Tk,D], got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    _check_devices(q, k, v)


def _check_devices(q, k, v) -> None:
    devs = {q.device, k.device, v.device}
    if len(devs) != 1:
        raise ValueError(f"attention: operands on several devices {devs}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"attention: unsupported device {q.device}")


def _kernel_operand(t: torch.Tensor) -> torch.Tensor:
    """t itself when K5/K6/K7 can read it through its strides (head dim
    contiguous, 16-byte aligned rows), else a contiguous copy."""
    if (t.stride(3) == 1 and all(s % 8 == 0 for s in t.stride()[:3])
            and t.data_ptr() % 16 == 0):
        return t
    return t.contiguous()


def _kernel_checks(what: str, tensors, head_dim: int) -> None:
    if head_dim != KERNEL_HEAD_DIM:
        raise ValueError(f"attention kernel {what} takes head_dim "
                         f"{KERNEL_HEAD_DIM}, got {head_dim}")
    if any(t.dtype != torch.bfloat16 for t in tensors):
        raise TypeError(f"attention kernel {what} takes bf16, got "
                        f"{[str(t.dtype) for t in tensors]}")


def _device_check(what: str, tensors) -> None:
    if any(t.device.type != "cuda" or t.device != tensors[0].device
           for t in tensors):
        raise ValueError(f"attention kernel {what} takes CUDA tensors on "
                         f"one device, got {tensors[0].device}")


def attention_bthd_kernel(q, k, v, scale: float):
    """Launch K5: q, k, v [B,T,H,64] bf16 on one CUDA device ->
    (o [B,T,H,64] bf16, l2 [B·H, T] f32)."""
    _check(q, k, v)
    B, T, H, D = q.shape
    _kernel_checks("K5", (q, k, v), D)
    _device_check("K5", (q, k, v))
    q, k, v = (_kernel_operand(t) for t in (q, k, v))
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


def _launch_bhtd(what: str, entry: str, counter: str, q, k, v,
                 q_scale: float, with_l2: bool = True):
    """Launch one of the [B, H, T, D] forward kernels (K6, K9, K11, K13a/b)
    through its C entry ``entry``: o laid out as a [B, T, H, 64] tensor
    and, with ``with_l2``, l2 [B·H, T] f32."""
    _check_bhtd(q, k, v)
    B, H, T, D = q.shape
    Tk = k.shape[2]
    _kernel_checks(what, (q, k, v), D)
    _device_check(what, (q, k, v))
    q, k, v = (_kernel_operand(t) for t in (q, k, v))
    o = _bthd(torch.empty((B, T, H, D), dtype=q.dtype, device=q.device))
    l2 = (torch.empty((B * H, T), dtype=torch.float32, device=q.device)
          if with_l2 else None)
    strides = [s for t in (q, k, v, o) for s in t.stride()[:3]]
    outs = [o.data_ptr()] + ([l2.data_ptr()] if with_l2 else [])
    code = getattr(_build.library(), entry)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), *outs, B, H, T, Tk,
        *strides, q_scale, _build.stream_ptr(q.device))
    _build.launch_counts[counter] += 1
    _build.check(code, counter)
    return o, l2


def flash_attention_kernel(q, k, v, scale: float):
    """Launch K6: q [B,H,T,64] and k, v [B,H,Tk,64] bf16 on one CUDA device
    (any strides with the head dim contiguous; a ``transpose(1, 2)`` view
    of [B,T,H,64] tensors is read in place) -> (o [B,H,T,64] bf16, laid
    out as a [B,T,H,64] tensor so that its [B,T,H·64] reshape is free,
    l2 [B·H, T] f32)."""
    return _launch_bhtd("K6", "lsx_flash_attention_bhtd_fwd",
                        "flash_attention_bhtd", q, k, v,
                        float(_scale2(scale, torch.bfloat16)))


def flash_attention_online_kernel(q, k, v, scale: float):
    """Launch K9, the online softmax, on K6's operands -> (o [B,H,T,64]
    bf16 laid out as K6's, l2 = m + log2 l [B·H, T] f32). Its rescale falls
    after every 64-key tile (``KERNEL_BLOCK_K``), where JAX's falls after
    every ``block_k`` keys; :func:`flash_attention_online_plain` with
    ``block_k=KERNEL_BLOCK_K`` has its rounding points."""
    return _launch_bhtd("K9", "lsx_flash_attention_online_fwd",
                        "flash_attention_online", q, k, v,
                        float(_scale2(scale, torch.bfloat16)))


def flash_attention_h2_kernel(q, k, v, scale: float):
    """Launch K11, the natural-exp online softmax, on K6's operands -> o
    [B,H,T,64] bf16 laid out as K6's. One head per block: JAX's head pairs
    are its MXU layout and carry no function, so B·H may be odd."""
    return _launch_bhtd("K11", "lsx_flash_attention_h2_fwd",
                        "flash_attention_h2", q, k, v,
                        float(torch.tensor(scale, dtype=torch.bfloat16)),
                        with_l2=False)[0]


def flash_attention_exp2_kernel(q, k, v, scale: float):
    """Launch K13a, the exp2 online softmax whose normalizer sums the
    unrounded p, on K6's operands -> o [B,H,T,64] bf16 laid out as K6's.
    Its rescale falls after every 64-key tile: its plain version is
    :func:`flash_attention_exp2_plain` with ``block_k=KERNEL_BLOCK_K``."""
    return _launch_bhtd("K13a", "lsx_flash_attention_exp2_fwd",
                        "flash_attention_exp2", q, k, v,
                        float(_scale2(scale, torch.bfloat16)),
                        with_l2=False)[0]


def flash_attention_exp2_bf16_kernel(q, k, v, scale: float):
    """Launch K13b, K13a with p = exp2(bf16(s − m')) two at a time in
    packed bf16 (``ex2.approx.ftz.bf16x2``), on K6's operands -> o
    [B,H,T,64] bf16 laid out as K6's. The packed exp may differ from the
    f32 exp2 rounded to bf16 by a bf16 ulp of p."""
    return _launch_bhtd("K13b", "lsx_flash_attention_exp2_bf16_fwd",
                        "flash_attention_exp2_bf16", q, k, v,
                        float(_scale2(scale, torch.bfloat16)),
                        with_l2=False)[0]


def exp2_bf16x2_plain(x: torch.Tensor) -> torch.Tensor:
    """exp2 of bf16 values, computed in f32 and rounded to bf16."""
    return torch.exp2(x.float()).to(torch.bfloat16)


def exp2_bf16x2_kernel(x: torch.Tensor) -> torch.Tensor:
    """K13b's packed exp alone (``ex2.approx.ftz.bf16x2``, two bf16 per
    instruction, subnormal results flushed to 0) on ``x`` [n] bf16, n even,
    on a CUDA device, to measure it against :func:`exp2_bf16x2_plain`."""
    if x.dtype != torch.bfloat16 or x.dim() != 1 or x.numel() % 2:
        raise ValueError(f"exp2_bf16x2 takes [n] bf16 with n even, got "
                         f"{tuple(x.shape)} {x.dtype}")
    _device_check("exp2_bf16x2", (x,))
    x = x.contiguous()
    y = torch.empty_like(x)
    code = _build.library().lsx_exp2_bf16x2(
        x.data_ptr(), y.data_ptr(), x.numel(), _build.stream_ptr(x.device))
    _build.launch_counts["exp2_bf16x2"] += 1
    _build.check(code, "exp2_bf16x2")
    return y


def flash_attention_backward_plain(q, k, v, o, l2, do, scale: float,
                                   q_chunk: int = PLAIN_Q_CHUNK):
    """K7's plain version in [B, H, T, D]: (dq, dk, dv) in q's dtype from
    the forward's q [B,H,T,D], k, v [B,H,Tk,D], o, l2 [B·H, T] f32 and the
    output gradient do, one chunk of query rows at a time (so no
    [B, H, T, Tk] array is held)."""
    B, H, T, D = q.shape
    dt = q.dtype
    s2 = _scale2(scale, dt).to(q.device)
    kf, vf = k.float(), v.float()                       # [B,H,Tk,D]
    dvec = (do.float() * o.float()).sum(-1)             # [B,H,T]
    l2 = l2.reshape(B, H, T)
    dk = torch.zeros_like(kf)
    dv = torch.zeros_like(vf)
    dqs = []
    for lo in range(0, T, q_chunk):
        hi = min(lo + q_chunk, T)
        qc = (q[:, :, lo:hi] * s2).float()                     # [B,H,c,D]
        doc = do[:, :, lo:hi].float()
        p = torch.exp2(torch.matmul(qc, kf.transpose(-1, -2))
                       - l2[..., lo:hi, None])                 # [B,H,c,Tk]
        dp = torch.matmul(doc, vf.transpose(-1, -2))
        ds = (p * (dp - dvec[..., lo:hi, None])).to(dt).float()
        del dp
        dv += torch.matmul(p.to(dt).float().transpose(-1, -2), doc)
        del p
        dk += torch.matmul(ds.transpose(-1, -2), qc)
        dqs.append((torch.matmul(ds, kf) * scale).to(dt))
    dq = torch.cat(dqs, dim=2)
    return dq, (dk * (1.0 / LOG2E)).to(dt), dv.to(dt)


def attention_bthd_backward_plain(q, k, v, o, l2, do, scale: float,
                                  q_chunk: int = PLAIN_Q_CHUNK):
    """(dq, dk, dv) [B,T,H,D] in q's dtype from the forward's q, k, v, o,
    l2 [B·H, T] f32 and the output gradient do, with K7's rounding points:
    :func:`flash_attention_backward_plain` on the [B, H, T, D] views."""
    grads = flash_attention_backward_plain(
        *(_bthd(t) for t in (q, k, v, o)), l2, _bthd(do), scale, q_chunk)
    return tuple(_bthd(g) for g in grads)


def attention_bthd_backward_launch(q, k, v, o, l2, do, scale: float):
    """K7's operands, prepared as :func:`attention_bthd_backward_kernel`
    prepares them, and ``(launch, dq, dk, dv)``: ``launch()`` runs the
    kernel alone, adding dq into the f32 [B,H,T,64] ``dq`` and writing the
    bf16 [B,Tk,H,64] ``dk`` and ``dv``."""
    _check_bthd_kv(q, k, v)
    B, T, H, D = q.shape
    Tk = k.shape[1]
    _kernel_checks("K7", (q, k, v, o, do), D)
    if l2 is None or l2.dtype != torch.float32 or l2.shape != (B * H, T):
        raise ValueError(f"attention kernel K7 needs the forward's l2 "
                         f"[{B * H}, {T}] f32, got "
                         f"{None if l2 is None else (tuple(l2.shape), l2.dtype)}")
    if o.shape != q.shape or do.shape != q.shape:
        raise ValueError("attention kernel K7 wants o and do of q's shape")
    _device_check("K7", (q, k, v, o, l2, do))
    # q' = bf16(q · bf16(scale·log2 e)) and dvec = Σ_d do·o in f32, as the
    # JAX package forms them in XLA around its kernel; l2 and dvec go to
    # the kernel in rows padded to whole 64-query tiles (its bulk copies
    # read a tile at a time; the padding is masked by index)
    qs = _kernel_operand(q * _scale2(scale, q.dtype).to(q.device))
    k, v, do_k = (_kernel_operand(t) for t in (k, v, do))
    Tp = -(-T // KERNEL_Q_TILE) * KERNEL_Q_TILE
    aux = torch.empty((2, B * H, Tp), dtype=torch.float32, device=q.device)
    aux[0, :, :T].copy_(l2)
    aux[1, :, :T].view(B, H, T).copy_(
        (do.float() * o.float()).sum(-1).transpose(1, 2))
    dq = torch.zeros((B, H, T, D), dtype=torch.float32, device=q.device)
    dk = torch.empty((B, Tk, H, D), dtype=q.dtype, device=q.device)
    dv = torch.empty((B, Tk, H, D), dtype=q.dtype, device=q.device)
    strides = [s for t in (qs, k, v, do_k) for s in t.stride()[:3]]
    stream = _build.stream_ptr(q.device)
    lib = _build.library()

    def launch():
        code = lib.lsx_flash_attention_bwd(
            qs.data_ptr(), k.data_ptr(), v.data_ptr(), do_k.data_ptr(),
            aux.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), B,
            T, Tk, H, *strides, float(scale), stream)
        _build.launch_counts["flash_attention_backward"] += 1
        _build.check(code, "flash_attention_backward")

    return launch, dq, dk, dv


def attention_bthd_backward_kernel(q, k, v, o, l2, do, scale: float):
    """Launch K7: q, o and do [B,T,H,64], k and v [B,Tk,H,64] bf16 and l2
    [B·H, T] f32 (from K5, K6 or K9) on one CUDA device -> dq [B,T,H,64],
    dk, dv [B,Tk,H,64] bf16. The kernel adds dq into a zeroed f32
    [B,H,T,64] scratch by bulk reductions; one cast and permute makes it
    dq."""
    launch, dq, dk, dv = attention_bthd_backward_launch(q, k, v, o, l2, do,
                                                        scale)
    launch()
    dq = dq.transpose(1, 2).to(q.dtype, memory_format=torch.contiguous_format)
    return dq, dk, dv


def flash_attention_backward_kernel(q, k, v, o, l2, do, scale: float):
    """K7 on [B, H, T, D] operands, k and v with their own key length Tk
    (the backward of K6 and K9, and so K12's split kernels): the kernel
    reads their [B, T, H, D] views in place, dk and dv come back as
    [B, H, T, D] views and dq is its f32 [B, H, T, D] scratch, cast."""
    launch, dq, dk, dv = attention_bthd_backward_launch(
        *(_bthd(t) for t in (q, k, v, o)), l2, _bthd(do), scale)
    launch()
    return dq.to(q.dtype), _bthd(dk), _bthd(dv)


def _attention_fn(name: str, fwd_kernel, fwd_plain, bwd_kernel, bwd_plain):
    """An autograd function over one layout's forward and backward: the
    kernels on CUDA tensors, the plain versions on CPU tensors or with
    ``plain=True``. Saves q, k, v, o and l2 for the backward, as the JAX
    custom_vjp does. ``apply(q, k, v, scale, plain)``."""

    class Fn(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, k, v, scale: float, plain: bool):
            use_plain = plain or q.device.type == "cpu"
            o, l2 = (fwd_plain if use_plain else fwd_kernel)(q, k, v, scale)
            ctx.save_for_backward(q, k, v, o, l2)
            ctx.scale, ctx.use_plain = scale, use_plain
            return o

        @staticmethod
        def backward(ctx, do):
            q, k, v, o, l2 = ctx.saved_tensors
            bwd = bwd_plain if ctx.use_plain else bwd_kernel
            dq, dk, dv = bwd(q, k, v, o, l2, do, ctx.scale)
            return dq, dk, dv, None, None

    Fn.__name__ = Fn.__qualname__ = name
    return Fn


FlashBTHDFn = _attention_fn("FlashBTHDFn", attention_bthd_kernel,
                            attention_bthd_plain,
                            attention_bthd_backward_kernel,
                            attention_bthd_backward_plain)
FlashFn = _attention_fn("FlashFn", flash_attention_kernel,
                        flash_attention_plain,
                        flash_attention_backward_kernel,
                        flash_attention_backward_plain)
OnlineFn = _attention_fn("OnlineFn", flash_attention_online_kernel,
                         flash_attention_online_plain,
                         flash_attention_backward_kernel,
                         flash_attention_backward_plain)


def flash_attention(q, k, v, scale: Optional[float] = None,
                    bounded_logits: bool = False):
    """[B,H,T,D] q and [B,H,Tk,D] k, v -> [B,H,T,D], non-causal, in q's
    dtype, differentiable. On CUDA tensors the kernels (they raise on a
    head dim or dtype they do not take): K9 forward with the online
    softmax, or with ``bounded_logits=True`` (|natural logits| well below
    80, as under the DiT's qk-LayerNorm) K6 with no running max, and K7
    backward for both. On CPU tensors their plain versions, K9's with
    JAX's default block of 1024 keys. One difference from a CPU call: on
    the card K9 rescales after every 64-key tile, so bf16(p), and so o,
    may round differently, at the 2⁻⁸ level."""
    _check_bhtd(q, k, v)
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    fn = FlashFn if bounded_logits else OnlineFn
    return fn.apply(q, k, v, float(scale), False)


def flash_attention_h2(q, k, v, scale: Optional[float] = None):
    """[B,H,T,D] q and [B,H,Tk,D] k, v -> [B,H,T,D] in q's dtype, the JAX
    package's head-pair forward in the natural-exp domain: K11 on CUDA
    tensors (a head dim other than 64 or a dtype other than bf16 raises;
    the kernel's key tile is 64), the plain version with JAX's default key
    block of 512 on CPU tensors. Forward only, as in JAX, which has no VJP
    for it: an input that requires grad raises. Odd B·H is taken (JAX
    asserts it even for its MXU packing)."""
    _check_bhtd(q, k, v)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise ValueError("flash_attention_h2 is forward only (the JAX "
                         "package has no VJP for it): detach its inputs or "
                         "use flash_attention")
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return flash_attention_h2_plain(q, k, v, float(scale))
    return flash_attention_h2_kernel(q, k, v, float(scale))


def attention_auto(q, k, v, scale: Optional[float] = None,
                   dtype: torch.dtype = torch.bfloat16,
                   flash_threshold: int = 2048,
                   bounded_logits: bool = False):
    """[B,H,T,D] attention dispatch, the JAX package's: on CUDA tensors
    with T >= ``flash_threshold``, :func:`flash_attention` (K9 forward, or
    K6 for bounded logits, and K7 backward); below the threshold or on the
    CPU, the einsum softmax (logits in f32 from ``dtype`` operands, p in
    ``dtype``). The output has q's dtype."""
    T = q.shape[2]
    out_dtype = q.dtype
    if q.device.type == "cuda" and T >= flash_threshold:
        return flash_attention(q.to(dtype), k.to(dtype), v.to(dtype), scale,
                               bounded_logits=bounded_logits).to(out_dtype)
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bhqd,bhkd->bhqk", q.to(dtype).float(),
                          k.to(dtype).float())
    p = torch.softmax(logits * scale, dim=-1).to(dtype)
    return torch.einsum("bhqk,bhkd->bhqd", p.float(),
                        v.to(dtype).float()).to(out_dtype)


def attention_bthd(q, k, v, scale: Optional[float] = None,
                   dtype: torch.dtype = torch.bfloat16, plain: bool = False,
                   tensor_parallel: bool = False):
    """[B, T, H, D] non-causal attention for bounded logits. q, k, v are
    cast to ``dtype``; the output has q's dtype, and its gradient reaches
    the backward in ``dtype``. K5 forward and K7 backward on CUDA tensors
    (they raise on a head dim or dtype they do not take, with no
    fallback), the plain versions on CPU tensors or when the caller asks
    for them with ``plain=True`` (the DiT's plain path). With
    ``tensor_parallel=True`` (a tensor-parallel shard's attention over its
    own heads; JAX's ``tensor_parallel`` context) it follows the JAX
    package instead: the [B, H, T, D] views go to :func:`attention_auto`
    (or, with ``plain=True``, to K6's plain version), without a copy."""
    _check(q, k, v)
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    out_dtype = q.dtype
    if tensor_parallel:
        qh, kh, vh = _bthd(q), _bthd(k), _bthd(v)
        if plain:
            o = FlashFn.apply(qh.to(dtype), kh.to(dtype), vh.to(dtype),
                              float(scale), True)
        else:
            o = attention_auto(qh, kh, vh, scale, dtype,
                               bounded_logits=True)
        return _bthd(o).to(out_dtype)
    qd, kd, vd = q.to(dtype), k.to(dtype), v.to(dtype)
    o = FlashBTHDFn.apply(qd, kd, vd, float(scale), bool(plain))
    return o.to(out_dtype)
