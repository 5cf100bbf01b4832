"""Multi-process runs of the tensor- and data-parallel DiT on the CPU.

The port's counterpart of the JAX package's ``_dryrun_dit`` and
``_dryrun_lora_tp`` (``__graft_entry__.py``): a tiny DiT on a (data,
model) mesh of gloo ranks, one full fine-tune step and one LoRA step.

    python -m langscenex_tpu_torch.parallel.dryrun --device cpu [--world 4]

Like every entry point of the port it runs on the card unless asked for
the CPU, and its tiny DiT (head dim 16, outside the attention kernels'
64) runs on the CPU only, as ``finetune --tiny`` does: without
``--device cpu`` it raises.

:func:`spawn` starts the ranks as fresh interpreters (``spawn``, not
``fork``), rendezvous through a ``FileStore`` in a temporary directory
(no TCP port), joins them within a time limit, kills them and raises when
they overrun, and returns what each rank's function returned. The rank
functions live here, so a spawned rank imports this package and nothing
else. :func:`forward_rank`, :func:`denoise_rank` and :func:`train_rank`
run the sharded DiT on given weights and inputs (numpy arrays) on a given
device (None: the rank's card); the parity tests hold them against the
JAX package on the CPU.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from .. import convert
from ..models.cogvideox.pipeline import denoise_loop
from ..models.cogvideox.scheduler import DDIMScheduler
from ..models.cogvideox.transformer import (CogVideoXTransformer,
                                            TransformerConfig, init_random_)
from ..train.dit import DiTTrainConfig, make_parallel_dit_train_step
from ..train.lora import LoRAConfig, make_lora_train_step
from ..utils.device import resolve_device
from .mesh import (Mesh, dit_sharded_apply, make_mesh, replicate_tree,
                   sharded_dit)

RANK_THREADS = 1           # torch threads per CPU rank
SPAWN_TIMEOUT = 120.0      # seconds a spawn may take before its ranks die

# the JAX package's dry-run DiT (__graft_entry__._dryrun_dit)
TINY = TransformerConfig(num_layers=1, num_heads=4, head_dim=16,
                         in_channels=8, out_channels=4, patch_size=2,
                         text_embed_dim=16, time_embed_dim=32,
                         attn_dtype=torch.float32, remat=True)


def _entry(rank: int, fn: Callable, world: int, store: str, out_dir: str,
           args: tuple) -> None:
    try:
        result = fn(rank, world, store, *args)
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn: Callable, world: int, args: tuple = (),
          timeout: float = SPAWN_TIMEOUT,
          workdir: Optional[str] = None) -> list:
    """Run ``fn(rank, world, store, *args)`` in ``world`` spawned processes
    and return their results in rank order. ``store`` is a fresh
    ``FileStore`` path for :func:`rank_mesh`. A rank that raises fails the
    call with its traceback; ranks still running after ``timeout`` seconds
    are killed and the call raises ``TimeoutError``. ``fn`` and ``args``
    must pickle by reference to an importable module (not a test file)."""
    with tempfile.TemporaryDirectory(dir=workdir) as tmp:
        store = os.path.join(tmp, "store")
        ctx = mp.start_processes(_entry, args=(fn, world, store, tmp, args),
                                 nprocs=world, join=False,
                                 start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=min(1.0, max(
                    0.0, deadline - time.monotonic()))):
                if time.monotonic() >= deadline:
                    raise TimeoutError(f"spawn: {world} ranks of "
                                       f"{getattr(fn, '__name__', fn)} still "
                                       f"running after {timeout:.0f} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           weights_only=False) for r in range(world)]


def rank_mesh(rank: int, world: int, store: str, n_data: int, n_model: int,
              device=None, backend: Optional[str] = None) -> Mesh:
    """The mesh of a spawned rank on ``device`` (None: the rank's card, as
    :func:`~.mesh.make_mesh` picks it; it raises without one), with
    :data:`RANK_THREADS` torch threads on the CPU."""
    if device is not None and torch.device(device).type == "cpu":
        torch.set_num_threads(RANK_THREADS)
    return make_mesh(n_data, n_model, backend=backend, device=device,
                     init_method=f"file://{store}", rank=rank,
                     world_size=world)


def _t(a, device=None) -> torch.Tensor:
    return torch.from_numpy(np.array(a)).to(device)


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy() if isinstance(
        tree, torch.Tensor) else tree


def _shard_model(mesh: Mesh, cfg: TransformerConfig, state_dict: dict):
    """This rank's shard of the DiT of ``cfg`` with the full
    ``state_dict``'s weights, on the mesh's device."""
    model = sharded_dit(cfg, mesh)
    model.load_state_dict(convert.shard_dit_state_dict(
        {k: _t(v) for k, v in state_dict.items()}, mesh.model_rank,
        mesh.n_model))
    return model


def forward_rank(rank, world, store, shape, device, cfg, state_dict,
                 inputs):
    """The sharded DiT's output on (latents, text, t), gathered over
    ``data``: every rank returns the whole batch's."""
    mesh = rank_mesh(rank, world, store, *shape, device=device)
    apply = dit_sharded_apply(_shard_model(mesh, cfg, state_dict), mesh)
    with torch.no_grad():
        return apply(*(_t(a, mesh.device) for a in inputs)).cpu().numpy()


def denoise_rank(rank, world, store, shape, device, cfg, state_dict, inputs,
                 pcfgs: list):
    """The CFG denoise loop with the sharded DiT (the pair on ``data``)
    from (noise, image latents, text cond, text uncond), once per
    ``PipelineConfig`` of ``pcfgs``; every rank returns its final latents
    of each."""
    mesh = rank_mesh(rank, world, store, *shape, device=device)
    apply = dit_sharded_apply(_shard_model(mesh, cfg, state_dict), mesh)
    with torch.no_grad():
        return [denoise_loop(apply, *(_t(a, mesh.device) for a in inputs),
                             DDIMScheduler(), pcfg).cpu().numpy()
                for pcfg in pcfgs]


def train_rank(rank, world, store, shape, device, cfg, state_dict, batch,
               draws, train_cfg: DiTTrainConfig, lora=None,
               lora_cfg: Optional[LoRAConfig] = None):
    """Train steps of the sharded DiT over the global ``batch``, one per
    (t, noise) of ``draws``: the full fine-tune through
    ``make_parallel_dit_train_step``, or with ``lora`` (the full adapters)
    the LoRA step on the mesh. Returns the metrics of each step and the
    rank's (data, model) position with its shard of the parameters or
    adapters after the last step."""
    mesh = rank_mesh(rank, world, store, *shape, device=device)
    dev = mesh.device
    model = _shard_model(mesh, cfg, state_dict)
    tb = {k: _t(v, dev) for k, v in batch.items()}
    if lora is None:
        init_state, step = make_parallel_dit_train_step(model, mesh,
                                                        train_cfg)
        state = init_state()
    else:
        init_state, step = make_lora_train_step(model, train_cfg, lora_cfg,
                                                mesh)
        state = init_state()
        # the zero moments of init_state fit the given adapters' shards
        state["lora"] = convert.shard_lora(
            {s: {k: _t(v, dev) for k, v in ab.items()}
             for s, ab in lora.items()},
            mesh.model_rank, mesh.n_model)
    metrics = []
    for t, noise in draws:
        state, m = step(state, tb, t=_t(t, dev), noise=_t(noise, dev))
        metrics.append({k: float(v) for k, v in m.items()})
    out = state["params"] if lora is None else state["lora"]
    return {"metrics": metrics, "position": (mesh.data_rank, mesh.model_rank),
            "shard": _numpy(out)}


def _dryrun_rank(rank, world, store, shape, device):
    """Both steps of the dry run on one rank, from weights that rank 0
    draws and broadcasts."""
    mesh = rank_mesh(rank, world, store, *shape, device=device)
    full = CogVideoXTransformer(TINY, device=mesh.device)
    init_random_(full, torch.Generator(mesh.device).manual_seed(rank))
    sd = replicate_tree(full.state_dict(), mesh)
    rng = np.random.default_rng(1)
    B = mesh.n_data
    batch = {k: _t(rng.normal(size=s).astype(np.float32), mesh.device)
             for k, s in (("x0", (B, 2, 4, 4, 4)), ("cond", (B, 2, 4, 4, 4)),
                          ("text", (B, 3, 16)))}
    cfg = DiTTrainConfig(warmup_steps=1, total_steps=10)
    out = {}
    for kind in ("dit", "lora"):
        model = sharded_dit(TINY, mesh)
        model.load_state_dict(convert.shard_dit_state_dict(
            sd, mesh.model_rank, mesh.n_model))
        if kind == "dit":
            init_state, step = make_parallel_dit_train_step(model, mesh, cfg)
        else:
            init_state, step = make_lora_train_step(model, cfg,
                                                    LoRAConfig(rank=4), mesh)
        state = init_state() if kind == "dit" else init_state(
            torch.Generator(mesh.device).manual_seed(1))
        _, m = step(state, batch, torch.Generator(mesh.device).manual_seed(2))
        out[kind] = float(m["loss"])
    return out


def dryrun(world: int = 4, device=None, timeout: float = SPAWN_TIMEOUT,
           workdir: Optional[str] = None) -> dict:
    """One full fine-tune step and one LoRA step of the tiny DiT on a
    (data = world / 2, model = 2) gloo mesh of ranks on ``device`` (the
    card by default, which raises without one; the tiny DiT runs on the
    CPU only, so pass ``device="cpu"``); raises unless every rank reports
    the same finite losses. Returns them."""
    dev = resolve_device(device)
    if dev.type != "cpu":
        raise ValueError(f"the dry run's tiny DiT (head dim 16) runs on the "
                         f"CPU only, not on {dev}: the attention kernels "
                         f"take head dim 64; pass device='cpu'")
    n_model = 2 if world % 2 == 0 else 1
    shape = (world // n_model, n_model)
    res = spawn(_dryrun_rank, world, (shape, str(dev)), timeout, workdir)
    for kind in ("dit", "lora"):
        losses = {r[kind] for r in res}
        if len(losses) != 1 or not np.isfinite(res[0][kind]):
            raise AssertionError(f"dryrun {kind}: rank losses {losses}")
        print(f"dryrun {kind} (data={shape[0]}, model={shape[1]}) OK: "
              f"loss={res[0][kind]:.4f}")
    return res[0]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--world", type=int, default=4)
    p.add_argument("--device", default=None,
                   help="torch device (default: the first CUDA card; the "
                        "tiny DiT runs with --device cpu only)")
    args = p.parse_args(argv)
    dryrun(args.world, args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
