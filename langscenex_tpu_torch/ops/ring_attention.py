"""Ring attention: exact sequence-parallel attention over the ranks of a
mesh's ``data`` axis, port of the JAX package's ``ops/ring_attention.py``
(a ``lax.ppermute`` scan inside ``shard_map``, not a Pallas kernel).

Every rank holds the global [B, H, T, D] q, k and v (the DiT runs
replicated on each rank) and computes the rows of its own token shard:
its k/v shard travels round the ring, rank r sending to r + 1 and
receiving from r - 1, and at each of the n steps the rank folds the shard
it holds into its rows' softmax. The rows of every rank are then gathered
in rank order, so each rank returns the whole output. Shards are the
ceil/floor split of T (the first T mod n ranks take one row more); there
is no pad and no mask (the JAX package pads T to a multiple of n and
masks the pad keys, which computes the same function).

The local block, by ``_build``'s rule:

* plain, the JAX package's ``_local_block``: logits in f32 from
  the working-dtype operands, a running max m, l and acc carried across
  the ring's steps, p rounded to v's dtype in the PV product, o = acc / l;
* with the kernels, K9's kernel (``flash_attention_online_kernel``) on the
  rank's rows against the shard's keys, with the shard's own key length:
  it returns o normalised over the shard and l2 = m + log2 l (base 2, of
  the logits times log2 e), and the partial results merge by their l2 in
  f32: o = (o_a·2^(l2_a - m) + o_b·2^(l2_b - m)) / (2^(l2_a - m) +
  2^(l2_b - m)), l2 = m + log2 of that denominator, m = max(l2_a, l2_b).

The backward (:class:`RingFn`) is a second ring pass: each step feeds the
rank's rows of the global o, its l2 and the output gradient do to K7 with
the shard's key length (``flash_attention_backward_kernel``, the K12
route), or to its plain version. dq accumulates at
home in f32; dk and dv (f32) travel with their shard, and one more step
brings them back to the shard's owner. Then dq, dk and dv are gathered
like the output.

The transport: ``torch.distributed`` isend/irecv on the data group. Gloo
takes no CUDA tensor for point-to-point or all_gather, so with the gloo
backend (ranks sharing one card) every message is staged through host
memory, as ``parallel/mesh.Mesh.all_gather_rows`` does; NCCL sends the
device tensors.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.distributed as dist

from .. import _build
from .flash_attention import (LOG2E, NEG_INF, flash_attention_backward_kernel,
                              flash_attention_backward_plain,
                              flash_attention_online_kernel)


def shard_sizes(T: int, n: int) -> list:
    """The ceil/floor split of T rows over n ranks (larger shards first)."""
    return [T // n + (1 if i < T % n else 0) for i in range(n)]


class _Ring:
    """Point-to-point and gather on the mesh's ``data`` group."""

    def __init__(self, mesh):
        self.group = mesh.data_group
        self.n = mesh.n_data if self.group is not None else 1
        self.rank = mesh.data_rank if self.group is not None else 0
        self.staged = mesh.backend == "gloo"

    def _peer(self, i: int) -> int:
        return dist.get_global_rank(self.group, i % self.n)

    def _out(self, t: torch.Tensor) -> torch.Tensor:
        t = t.contiguous()
        return t.cpu() if self.staged and t.device.type != "cpu" else t

    def shift(self, tensors: list, recv_rows: int) -> list:
        """Send the [B,H,T,D] ``tensors`` to rank + 1 and receive the same
        list (with ``recv_rows`` rows) from rank - 1, grouped by dtype into
        one message each."""
        dev = tensors[0].device
        by_dtype = {}
        for i, t in enumerate(tensors):
            by_dtype.setdefault(t.dtype, []).append(i)
        out = [None] * len(tensors)
        reqs, recvs = [], []
        for tag, (dt, idx) in enumerate(by_dtype.items()):
            send = self._out(torch.cat([tensors[i].reshape(-1)
                                        for i in idx]))
            shapes = []
            for i in idx:
                s = list(tensors[i].shape)
                s[2] = recv_rows
                shapes.append(s)
            recv = torch.empty(sum(math.prod(s) for s in shapes), dtype=dt,
                               device=send.device)
            reqs.append(dist.isend(send, self._peer(self.rank + 1),
                                   group=self.group, tag=tag))
            reqs.append(dist.irecv(recv, self._peer(self.rank - 1),
                                   group=self.group, tag=tag))
            recvs.append((recv, idx, shapes))
        for r in reqs:
            r.wait()
        for recv, idx, shapes in recvs:
            parts = recv.to(dev).split([math.prod(s) for s in shapes])
            for i, p, s in zip(idx, parts, shapes):
                out[i] = p.view(s)
        return out

    def gather(self, t: torch.Tensor, sizes: list):
        """Every rank's [B,H,T,D] ``t`` (its ``sizes[rank]`` rows)
        concatenated in rank order along T."""
        if self.n == 1:
            return t
        pad = max(sizes) - t.shape[2]
        src = self._out(torch.nn.functional.pad(t, (0, 0, 0, pad)))
        parts = [torch.empty_like(src) for _ in range(self.n)]
        dist.all_gather(parts, src, group=self.group)
        return torch.cat([p[:, :, :s] for p, s in zip(parts, sizes)],
                         2).to(t.device)


def _local_block(q, k, v, scale, m, l, acc):
    """One online-softmax step against a k/v shard (the JAX package's
    ``_local_block``): f32 logits, p in v's dtype in the PV product."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    m_new = torch.maximum(m, s.amax(-1, keepdim=True))
    p = torch.exp(s - m_new)
    alpha = torch.exp(m - m_new)
    l = l * alpha + p.sum(-1, keepdim=True)
    acc = acc * alpha + torch.einsum("bhqk,bhkd->bhqd",
                                     p.to(v.dtype).float(), v.float())
    return m_new, l, acc


def _merge(o_a, l2_a, o_b, l2_b):
    """Two partial softmax outputs (o normalised over its keys, l2 base-2
    log normaliser [B,H,T]) merged into one, in f32."""
    m = torch.maximum(l2_a, l2_b)
    wa, wb = torch.exp2(l2_a - m), torch.exp2(l2_b - m)
    den = wa + wb
    o = (o_a * wa[..., None] + o_b.float() * wb[..., None]) / den[..., None]
    return o, m + torch.log2(den)


def _ring_forward(ring: _Ring, q, k, v, scale: float, sizes: list,
                  kernel: bool):
    """This rank's rows: (o [B,H,Tq,D] in q's dtype, l2 [B·H, Tq] f32),
    through K9 per block with ``kernel``, else the einsum block."""
    r, n = ring.rank, ring.n
    lo = sum(sizes[:r])
    qr = q[:, :, lo:lo + sizes[r]]
    k_cur = k[:, :, lo:lo + sizes[r]]
    v_cur = v[:, :, lo:lo + sizes[r]]
    B, H, Tq, D = qr.shape
    if kernel:
        o = l2 = None
    else:
        m = torch.full((B, H, Tq, 1), NEG_INF, device=q.device)
        l = torch.zeros((B, H, Tq, 1), device=q.device)
        acc = torch.zeros((B, H, Tq, D), device=q.device)
    for step in range(n):
        if kernel:
            ob, l2b = flash_attention_online_kernel(qr, k_cur, v_cur, scale)
            l2b = l2b.view(B, H, Tq)
            if o is None:
                o, l2 = ob.float(), l2b
            else:
                o, l2 = _merge(o, l2, ob, l2b)
        else:
            m, l, acc = _local_block(qr, k_cur, v_cur, scale, m, l, acc)
        if step < n - 1:
            # the shard this rank holds next started on rank r - step - 1
            k_cur, v_cur = ring.shift([k_cur, v_cur],
                                      sizes[(r - step - 1) % n])
    if not kernel:
        l = l.clamp(min=1e-30)
        o = acc / l
        l2 = m[..., 0] * LOG2E + torch.log2(l[..., 0])
    return o.to(q.dtype), l2.reshape(B * H, Tq)


class RingFn(torch.autograd.Function):
    """The ring forward and its ring backward over global [B,H,T,D]
    tensors; every rank returns the global output and gradients."""

    @staticmethod
    def forward(ctx, q, k, v, mesh, scale: float):
        ring = _Ring(mesh)
        sizes = shard_sizes(q.shape[2], ring.n)
        kernel = _build.use_kernel(q)
        o, l2 = _ring_forward(ring, q, k, v, scale, sizes, kernel)
        ctx.save_for_backward(q, k, v, o, l2)
        ctx.ring, ctx.sizes, ctx.scale = ring, sizes, scale
        ctx.kernel = kernel
        return ring.gather(o, sizes)

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, l2 = ctx.saved_tensors
        ring, sizes, scale = ctx.ring, ctx.sizes, ctx.scale
        r, n = ring.rank, ring.n
        lo = sum(sizes[:r])
        rows = slice(lo, lo + sizes[r])
        qr, dor = q[:, :, rows], do[:, :, rows].to(q.dtype)
        k_cur, v_cur = k[:, :, rows], v[:, :, rows]
        bwd = (flash_attention_backward_kernel if ctx.kernel
               else flash_attention_backward_plain)
        dq = torch.zeros(qr.shape, dtype=torch.float32, device=q.device)
        dk = torch.zeros(k_cur.shape, dtype=torch.float32, device=q.device)
        dv = torch.zeros_like(dk)
        for step in range(n):
            gq, gk, gv = bwd(qr, k_cur, v_cur, o, l2, dor, scale)
            dq += gq.float()
            dk += gk.float()
            dv += gv.float()
            # the shard (with its dk, dv) moves on; after n moves it is home
            nxt = sizes[(r - step - 1) % n]
            if step < n - 1:
                k_cur, v_cur, dk, dv = ring.shift([k_cur, v_cur, dk, dv],
                                                  nxt)
            elif n > 1:
                dk, dv = ring.shift([dk, dv], nxt)
        return (ring.gather(dq, sizes).to(q.dtype),
                ring.gather(dk, sizes).to(k.dtype),
                ring.gather(dv, sizes).to(v.dtype), None, None)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh,
                   scale: Optional[float] = None) -> torch.Tensor:
    """Exact non-causal attention of global [B,H,T,D] q, k, v held by every
    rank of ``mesh``'s ``data`` group, the token axis split over the ring;
    returns the global [B,H,T,D] output in q's dtype on every rank,
    differentiable. By ``_build``'s rule K9 forward and K7 backward (bf16,
    head dim 64; they raise on anything else), or the JAX package's einsum
    block and K7's plain version."""
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"ring_attention wants q, k, v [B,H,T,D] of one "
                         f"shape, got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    n = mesh.n_data if mesh.data_group is not None else 1
    if q.shape[2] < n:
        raise ValueError(f"ring_attention: {q.shape[2]} tokens over a ring "
                         f"of {n} ranks leaves a rank no rows")
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    return RingFn.apply(q, k, v, mesh, float(scale))
