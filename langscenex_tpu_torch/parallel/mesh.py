"""The (data, model) process mesh and the DiT's sharding over it.

Port of the JAX ``langscenex_tpu/parallel/mesh.py`` onto
``torch.distributed``: one process per mesh position, rank
``d · n_model + m`` at (data d, model m). DP over the CFG pair or the
fine-tune videos rides ``data``; TP over the attention heads and the MLP
hidden dimension rides ``model``. Where GSPMD chose the layout and
inserted the collectives from ``DIT_LOGICAL_RULES``, here
:data:`DIT_TP_PLAN` names the linears that are column- and row-parallel
(Megatron's split): each rank holds ``num_heads / n_model`` heads of
``to_q``/``to_k``/``to_v`` and ``4·hidden / n_model`` columns of
``ff.net.0.proj``, the matching input rows of ``attn1.to_out.0`` and
``ff.net.2``, and one all-reduce over ``model`` sums each row-parallel
product. The JAX package's TP is only a layout, so the port need only
match its outputs.

Collectives: :meth:`Mesh.copy_to_model` (identity forward, gradient
summed over ``model`` in the backward) feeds the column-parallel
projections; :meth:`Mesh.reduce_from_model` (sum over ``model``,
identity backward) closes the row-parallel ones. Replicated parameters
that see only the rank's heads (``norm_q``/``norm_k``, :data:`DIT_TP_PARTIAL`)
get partial gradients, which the train steps sum over ``model``.

Backends: ``nccl`` when every rank has a card of its own, ``gloo`` on the
CPU. NCCL refuses two ranks on one device, so ranks that share a card ask
for ``backend="gloo"`` explicitly; gloo takes CUDA tensors for
``all_reduce`` and ``broadcast`` (staged through host memory inside
gloo), which is all a ``(data=1, model=2)`` mesh runs. Its ``all_gather``
takes no CUDA tensors, so :meth:`Mesh.all_gather_rows` — used only with
``data > 1`` — stages them through the host itself. Every compute step
stays on the rank's device.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.distributed as dist
import torch.nn as nn

from ..models.cogvideox.transformer import (CogVideoXTransformer,
                                            TransformerConfig)
from ..utils.device import default_device

# The DiT's tensor-parallel plan, the counterpart of the JAX package's
# DIT_LOGICAL_RULES: module suffix (under transformer_blocks.<i>.) ->
# "column" (output features split: weight rows and bias) or "row" (input
# features split: weight columns; bias replicated, added once). The LoRA
# site attn1.to_qkv covers the three column-parallel q/k/v projections.
DIT_TP_PLAN = {
    "attn1.to_q": "column", "attn1.to_k": "column", "attn1.to_v": "column",
    "attn1.to_qkv": "column", "attn1.to_out.0": "row",
    "ff.net.0.proj": "column", "ff.net.2": "row",
}
# replicated parameters that act on the rank's heads only: their
# gradients are partial sums over 'model'
DIT_TP_PARTIAL = ("attn1.norm_q", "attn1.norm_k")
_BUCKET = 1 << 24          # elements per all-reduce of many gradients


@dataclasses.dataclass(eq=False)
class Mesh:
    """This process's place in the (data, model) mesh and its two
    subgroups (None where the axis has size 1)."""
    n_data: int
    n_model: int
    rank: int
    backend: str
    device: torch.device
    data_group: Optional[object] = None
    model_group: Optional[object] = None

    @property
    def data_rank(self) -> int:
        return self.rank // self.n_model

    @property
    def model_rank(self) -> int:
        return self.rank % self.n_model

    def group(self, axis: str):
        return {"data": self.data_group, "model": self.model_group}[axis]

    def all_reduce_(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """Sum ``t`` (contiguous) in place over ``axis``; returns it."""
        g = self.group(axis)
        if g is not None:
            dist.all_reduce(t, group=g)
        return t

    def all_reduce_many_(self, tensors, axis: str) -> None:
        """Sum every tensor in place over ``axis``, flattened into buckets
        of one dtype, so a model's gradients take a few collectives."""
        if self.group(axis) is None:
            return
        by_dtype = {}
        for t in tensors:
            by_dtype.setdefault(t.dtype, []).append(t)
        for ts in by_dtype.values():
            while ts:
                n, take = 0, []
                while ts and (not take or n + ts[0].numel() <= _BUCKET):
                    n += ts[0].numel()
                    take.append(ts.pop(0))
                flat = self.all_reduce_(torch.cat([t.reshape(-1)
                                                   for t in take]), axis)
                for t, part in zip(take, flat.split([t.numel()
                                                     for t in take])):
                    t.copy_(part.view_as(t))

    def all_gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        """The rows of every rank of ``data`` concatenated in rank order.
        Used only with data > 1; gloo gathers no CUDA tensor, so those
        travel through host memory."""
        if self.data_group is None:
            return t
        staged = self.backend == "gloo" and t.device.type != "cpu"
        src = t.detach().contiguous().cpu() if staged else t.contiguous()
        parts = [torch.empty_like(src) for _ in range(self.n_data)]
        dist.all_gather(parts, src, group=self.data_group)
        return torch.cat(parts).to(t.device)

    def copy_to_model(self, x: torch.Tensor) -> torch.Tensor:
        """Identity forward; the gradient summed over ``model`` in the
        backward (the input of column-parallel projections)."""
        return x if self.model_group is None else _CopyToModel.apply(x, self)

    def reduce_from_model(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` over ``model``; identity backward (the output
        of row-parallel projections)."""
        if self.model_group is None:
            return x
        return _ReduceFromModel.apply(x, self)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        return ctx.mesh.all_reduce_(g, "model"), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return mesh.all_reduce_(x.clone(memory_format=torch.contiguous_format),
                                "model")

    @staticmethod
    def backward(ctx, g):
        return g, None


def resolve_backend(backend: Optional[str], device: torch.device,
                    world_size: int) -> str:
    """``backend``, or for None: ``gloo`` on the CPU, ``nccl`` when every
    rank has a card of its own. NCCL refuses two ranks on one device, so
    ranks that share a card must ask for ``gloo`` themselves."""
    if backend is not None:
        return backend
    if device.type == "cpu":
        return "gloo"
    if device.type == "cuda" and torch.cuda.device_count() >= world_size:
        return "nccl"
    raise ValueError(
        f"{world_size} ranks on {torch.cuda.device_count()} card(s): NCCL "
        f"refuses two ranks on one device; pass backend='gloo' to share a "
        f"card")


def make_mesh(n_data: Optional[int] = None, n_model: int = 1,
              backend: Optional[str] = None,
              device: torch.device | str | None = None,
              init_method: Optional[str] = None, rank: Optional[int] = None,
              world_size: Optional[int] = None) -> Mesh:
    """The (data, model) mesh of this process. Initialises the default
    process group from (``init_method``, ``rank``, ``world_size``) when it
    is not yet initialised, with ``backend`` as in :func:`resolve_backend`
    (an initialised group keeps its own); ``device`` defaults to the
    rank's card (``cuda:<rank % cards>``) and raises without one. Every
    rank must call it with the same
    arguments (the subgroups are made collectively)."""
    if not dist.is_initialized():
        if init_method is None or rank is None or world_size is None:
            raise ValueError("make_mesh: the process group is not "
                             "initialised; pass init_method, rank and "
                             "world_size")
    else:
        rank, world_size = dist.get_rank(), dist.get_world_size()
    if device is None:
        default_device()                # raises without a card
        device = torch.device("cuda", rank % torch.cuda.device_count())
    device = torch.device(device)
    if device.type == "cuda" and device.index is not None:
        torch.cuda.set_device(device)
    if dist.is_initialized():
        backend = dist.get_backend()
    else:
        backend = resolve_backend(backend, device, world_size)
        dist.init_process_group(backend, init_method=init_method,
                                world_size=world_size, rank=rank)
    n_data = n_data or world_size // n_model
    if n_data * n_model != world_size:
        raise ValueError(f"mesh (data={n_data}, model={n_model}) does not "
                         f"cover {world_size} ranks")
    mesh = Mesh(n_data, n_model, rank, backend, device)
    if n_model > 1:
        for d in range(n_data):
            g = dist.new_group([d * n_model + m for m in range(n_model)])
            if d == mesh.data_rank:
                mesh.model_group = g
    if n_data > 1:
        for m in range(n_model):
            g = dist.new_group([d * n_model + m for d in range(n_data)])
            if m == mesh.model_rank:
                mesh.data_group = g
    return mesh


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def shard_batch_tree(tree, mesh: Mesh):
    """This rank's rows on ``data`` of every tensor leaf with a leading
    batch axis (its share of the global batch, in rank order)."""
    def take(x):
        if not isinstance(x, torch.Tensor) or x.dim() == 0:
            return x
        if x.shape[0] % mesh.n_data:
            raise ValueError(f"batch {x.shape[0]} does not split over "
                             f"{mesh.n_data} data ranks")
        per = x.shape[0] // mesh.n_data
        return x[mesh.data_rank * per:(mesh.data_rank + 1) * per]
    return _tree_map(take, tree)


def replicate_tree(tree, mesh: Mesh):
    """Every tensor leaf as rank 0 holds it (a broadcast from rank 0)."""
    def bcast(x):
        if not isinstance(x, torch.Tensor):
            return x
        y = x.detach().clone(memory_format=torch.contiguous_format)
        dist.broadcast(y, src=0)
        return y
    return _tree_map(bcast, tree)


def tp_split_dim(key: str) -> Optional[int]:
    """The dimension along which :data:`DIT_TP_PLAN` splits the parameter
    ``key`` (a state_dict key), or None when it is replicated."""
    for site, kind in DIT_TP_PLAN.items():
        if key.endswith(f".{site}.weight"):
            return 0 if kind == "column" else 1
        if key.endswith(f".{site}.bias") and kind == "column":
            return 0
    return None


def shard_tensor(t: torch.Tensor, dim: Optional[int], rank: int,
                 n_model: int) -> torch.Tensor:
    """Part ``rank`` of ``n_model`` equal parts of t along ``dim`` (t
    itself for None)."""
    if dim is None or n_model == 1:
        return t
    if t.shape[dim] % n_model:
        raise ValueError(f"dimension {dim} of {tuple(t.shape)} does not "
                         f"split over {n_model} model ranks")
    n = t.shape[dim] // n_model
    return t.narrow(dim, rank * n, n)


def _site_kind(site: str) -> Optional[str]:
    for suffix, kind in DIT_TP_PLAN.items():
        if site.endswith("." + suffix):
            return kind
    return None


def lora_split_dim(site: str, key: str) -> Optional[int]:
    """The dimension along which an adapter tensor (``key`` "a" [in, r] or
    "b" [r, out]) of ``site`` is split: B's columns at a column-parallel
    site, A's rows at a row-parallel one; the other factor is
    replicated."""
    kind = _site_kind(site)
    if kind == "column" and key == "b":
        return 1
    if kind == "row" and key == "a":
        return 0
    return None


def shard_lora_tensor(site: str, key: str, t: torch.Tensor, rank: int,
                      n_model: int) -> torch.Tensor:
    """Part ``rank`` of an adapter tensor. The fused q/k/v adapter's B
    [r, 3·hidden], whose columns are [q | k | v], keeps the rank's heads of
    each of the three."""
    dim = lora_split_dim(site, key)
    if site.endswith(".attn1.to_qkv") and dim is not None:
        r = t.shape[0]
        return shard_tensor(t.reshape(r, 3, -1), 2, rank,
                            n_model).reshape(r, -1)
    return shard_tensor(t, dim, rank, n_model)


def lora_kind(site: str, key: str) -> str:
    """:func:`param_kind` of an adapter tensor: the split factor is
    "sharded"; the replicated factor of a TP site gets a partial gradient
    (A at a column-parallel site feeds only the rank's columns of B; B at
    a row-parallel site sees only the rank's rows of A)."""
    if lora_split_dim(site, key) is not None:
        return "sharded"
    return "partial" if _site_kind(site) is not None else "replicated"


def param_kind(name: str) -> str:
    """How the TP step treats a parameter of the DiT: "sharded" (split by
    the plan: its squares summed over ``model`` in the global norm),
    "partial" (replicated, acting on the rank's heads: its gradient
    summed over ``model``) or "replicated"."""
    if tp_split_dim(name) is not None:
        return "sharded"
    if any(f".{p}." in f".{name}" for p in DIT_TP_PARTIAL):
        return "partial"
    return "replicated"


def reduce_gradients_(grads: dict, kinds: Optional[dict],
                      tp: Optional[Mesh], dp: Optional[Mesh]) -> None:
    """In place: with ``tp`` (a sharded model's mesh) the partial
    gradients summed over ``model``; with ``dp`` every gradient averaged
    over ``data`` (the mean loss of equal batch shards)."""
    if tp is not None:
        tp.all_reduce_many_([g for k, g in grads.items()
                             if kinds[k] == "partial"], "model")
    if dp is not None and dp.n_data > 1:
        dp.all_reduce_many_(list(grads.values()), "data")
        for g in grads.values():
            g.div_(dp.n_data)


def sharded_global_norm(grads: dict, kinds: dict, tp: Mesh) -> torch.Tensor:
    """sqrt of the sum of squares over every leaf of the unsharded model,
    in f32 (optax's global norm): the sharded leaves' squares summed over
    ``model``, replicated and partial ones (equal on every rank once
    reduced) counted once."""
    def sq(keep):
        return sum(((g.float() ** 2).sum() for k, g in grads.items()
                    if keep(kinds[k])), torch.zeros((), device=_dev(grads)))
    sharded = tp.all_reduce_(sq(lambda kind: kind == "sharded"), "model")
    return torch.sqrt(sharded + sq(lambda kind: kind != "sharded"))


def _dev(tree: dict) -> torch.device:
    return next(iter(tree.values())).device


def reduce_mean_(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """The mean of a per-rank value (a shard's loss) over ``data``."""
    if mesh is None or mesh.n_data == 1:
        return x
    return mesh.all_reduce_(x.detach().clone(), "data") / mesh.n_data


def sharded_dit(cfg: TransformerConfig, mesh: Mesh,
                device: torch.device | str | None = None
                ) -> CogVideoXTransformer:
    """This rank's shard of the DiT of ``cfg`` (the unsharded model when
    the mesh has no ``model`` axis), on ``device`` (the mesh's by
    default; ``"meta"`` allocates nothing)."""
    dev = mesh.device if device is None else device
    return CogVideoXTransformer(cfg, device=dev,
                                tp=mesh if mesh.n_model > 1 else None)


@torch.no_grad()
def materialize_sharded_dit(cfg: TransformerConfig, mesh: Mesh,
                            dtype: torch.dtype, generator: torch.Generator
                            ) -> CogVideoXTransformer:
    """This rank's shard of ``video_inference.materialize(
    CogVideoXTransformer(cfg), dtype, device, generator)``: every weight is
    drawn at its full shape from ``generator`` in the unsharded model's
    order, the rank's part kept and the rest dropped at once, so no rank
    ever holds the whole model."""
    shard = sharded_dit(cfg, mesh, "meta").to(dtype=dtype).to_empty(
        device=mesh.device)
    full = dict(CogVideoXTransformer(cfg, device="meta").named_modules())
    for name, m in shard.named_modules():
        if isinstance(m, (nn.Linear, nn.Conv2d, nn.Conv3d)):
            shape = full[name].weight.shape
            w = torch.empty(shape, dtype=m.weight.dtype,
                            device=m.weight.device)
            w.normal_(0.0, 1.0 / math.sqrt(math.prod(shape[1:])),
                      generator=generator)
            m.weight.copy_(shard_tensor(w, tp_split_dim(f"{name}.weight"),
                                        mesh.model_rank, mesh.n_model))
            del w
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, (nn.LayerNorm, nn.GroupNorm)):
            m.weight.fill_(1.0)
            m.bias.zero_()
    return shard.eval().requires_grad_(False)


def dit_sharded_apply(model: CogVideoXTransformer, mesh: Mesh):
    """``apply_fn(latents, text, t)`` over the global batch: this rank runs
    its rows on ``data`` through its shard ``model`` and, with ``data > 1``,
    gathers every rank's rows, so each rank returns the whole batch."""
    if mesh.n_model > 1 and getattr(model, "tp", None) is not mesh:
        raise ValueError("dit_sharded_apply: the model is not this mesh's "
                         "shard (build it with sharded_dit)")

    def apply_fn(latents, text, t):
        x, txt, tt = shard_batch_tree((latents, text, t), mesh)
        out = model(x, txt, tt)
        return mesh.all_gather_rows(out) if mesh.n_data > 1 else out
    return apply_fn
