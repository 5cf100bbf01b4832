"""Multi-process runs of the port's multi-device surfaces on the CPU.

The port's counterpart of the JAX package's multi-chip dry run
(``__graft_entry__._dryrun_impl``, ``_dryrun_dit``, ``_dryrun_sp`` and
``_dryrun_lora_tp``): on gloo ranks, one view-parallel field train step
(``_dryrun_impl``'s tiny scene: 64 splats, capacity 128, 32x16, every
loss flag on, phase "semantic", one view per rank), a tiny DiT's full
fine-tune step and LoRA step on a (data, model) mesh, and the 2-layer tiny
DiT's forward under ``sequence_parallel`` (the ring over every rank)
against its unsharded forward.

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
device (None: the rank's card); :func:`ring_rank` the ring attention,
:func:`sp_forward_rank` a DiT under ``sequence_parallel`` and
:func:`field_step_rank` the view-parallel field step; the parity tests
hold them against the JAX package on the CPU.
"""
from __future__ import annotations

import argparse
import dataclasses
import math
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
from ..ops.flash_attention import sequence_parallel
from ..ops.projection import RasterCamera
from ..ops.rasterize import RasterConfig
from ..ops.ring_attention import ring_attention
from ..ops.transforms import focal2fov, fov2focal, projection_matrix
from ..scene.gaussians import DensifyStats, create_from_points
from ..models.cogvideox.scheduler import DDIMScheduler
from ..models.cogvideox.transformer import (CogVideoXTransformer,
                                            TransformerConfig, init_random_)
from ..train import field
from ..train.dit import DiTTrainConfig, make_parallel_dit_train_step
from ..train.lora import LoRAConfig, make_lora_train_step
from ..train.optim import (make_app_optimizer, make_pose_optimizer,
                           make_splat_optimizer, splat_params)
from ..utils.config import OptimizationConfig
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
# the JAX package's sequence-parallel dry-run DiT (_dryrun_sp)
TINY_SP = TransformerConfig(num_layers=2, num_heads=4, head_dim=16,
                            in_channels=8, out_channels=4, patch_size=2,
                            text_embed_dim=16, time_embed_dim=32,
                            attn_dtype=torch.float32)
SP_ATOL = 5e-4             # _dryrun_sp's bound, ring vs unsharded forward


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
    """Numpy copies of a tree's tensors (a copy even on the CPU: spawning
    ranks moves pickled CPU tensors to shared memory and frees their old
    storage, which a view would still point at)."""
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    return tree.detach().to("cpu", copy=True).numpy() if isinstance(
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


def _to(tree, device):
    """Every tensor of a tree of dicts, lists, NamedTuples and dataclasses
    on ``device``."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_to(v, device) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to(v, device) for v in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _to(getattr(tree, f.name), device)
            for f in dataclasses.fields(tree)})
    return tree


def ring_rank(rank, world, store, device, cases: list):
    """The ring attention over all ``world`` ranks on each case (q, k, v
    numpy [B,H,T,D], with_grads): the output and, with with_grads, the
    gradients of sum(out²), every rank's global ones."""
    mesh = rank_mesh(rank, world, store, world, 1, device=device)
    res = []
    for q, k, v, with_grads in cases:
        qkv = [_t(a, mesh.device).requires_grad_(with_grads)
               for a in (q, k, v)]
        out = ring_attention(*qkv, mesh)
        grads = None
        if with_grads:
            grads = [g.float().cpu().numpy() for g in torch.autograd.grad(
                out.float().square().sum(), qkv)]
        res.append((out.detach().float().cpu().numpy(), grads))
    return res


def sp_forward_rank(rank, world, store, device, cfg, state_dict, inputs):
    """The DiT of ``cfg`` with ``state_dict``'s weights on (latents, text,
    t) under ``sequence_parallel`` over all ``world`` ranks."""
    mesh = rank_mesh(rank, world, store, world, 1, device=device)
    model = CogVideoXTransformer(cfg, device=mesh.device)
    model.load_state_dict({k: _t(v) for k, v in state_dict.items()})
    with torch.no_grad(), sequence_parallel(mesh):
        return model(*(_t(a, mesh.device) for a in inputs)).cpu().numpy()


def field_step_rank(rank, world, store, device, step_args: tuple, state,
                    batches: list, samples: list, sh_degree: int,
                    backend=None):
    """One view-parallel field step over ``world`` data ranks
    (:func:`field_step` on this rank's mesh)."""
    mesh = rank_mesh(rank, world, store, world, 1, device=device,
                     backend=backend)
    return field_step(mesh, step_args, state, batches, samples, sh_degree)


def field_step(mesh: Mesh, step_args: tuple, state, batches: list,
               samples: list, sh_degree: int) -> dict:
    """This rank's equal share of ``batches``/``samples`` (in rank order on
    ``data``) through ``make_parallel_train_step(*step_args, mesh)`` from
    ``state``. Returns the new state (numpy, ``field.state_dict``), the
    metrics, the step's seconds and the seconds of its all-reduce of the
    gradients."""
    per = len(batches) // mesh.n_data
    mine = slice(mesh.data_rank * per, (mesh.data_rank + 1) * per)
    st = _to(state, mesh.device)
    bs = _to(batches[mine], mesh.device)
    ss = _to(samples[mine], mesh.device)
    step = field.make_parallel_train_step(*_to(step_args, mesh.device),
                                          mesh)
    reduce_s = []
    inner = mesh.all_reduce_many_

    def timed(tensors, axis):
        _sync(mesh.device)
        t0 = time.perf_counter()
        inner(tensors, axis)
        _sync(mesh.device)
        reduce_s.append(time.perf_counter() - t0)
    mesh.all_reduce_many_ = timed
    _sync(mesh.device)
    t0 = time.perf_counter()
    new, metrics = step(st, bs, ss, sh_degree)
    _sync(mesh.device)
    del mesh.all_reduce_many_
    return {"state": _numpy(field.state_dict(new)),
            "metrics": {k: float(v) for k, v in metrics.items()},
            "step_s": time.perf_counter() - t0, "reduce_s": sum(reduce_s)}


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def field_dryrun_inputs(n_views: int, device):
    """The JAX package's ``_dryrun_impl`` scene on ``device``: 64 random
    splats (capacity 128), a 32x16 identity camera, ``n_views`` random
    views, every loss flag on (phase "semantic"). Returns
    (step_args without the mesh, state, batches, samples)."""
    W, H, n = 32, 16, 64
    rng = np.random.default_rng(0)
    splats = create_from_points(
        rng.uniform(-1, 1, (n, 3)).astype(np.float32),
        rng.uniform(0, 1, (n, 3)).astype(np.float32), capacity=128,
        device=device)
    cfg = OptimizationConfig(loss_obj_3d=True, grouping_loss=True,
                             multi_view_sample_num=64)
    rcfg = RasterConfig(tile_w=16, tile_h=8, max_tiles_per_splat=32,
                        chunk=32)
    fovx = 1.0
    fovy = focal2fov(fov2focal(fovx, W), H)
    eye = torch.eye(4, device=device)
    cam = RasterCamera(w2c=eye, proj=torch.as_tensor(
        projection_matrix(0.01, 100.0, fovx, fovy), dtype=torch.float32,
        device=device), width=W, height=H, tan_fovx=math.tan(fovx / 2),
        tan_fovy=math.tan(fovy / 2))
    flags = field.StepFlags(image=True, single_view=True, multiview=True,
                            lang=True, instance=False, optim_pose=True,
                            phase="semantic")
    B = n_views
    poses = torch.tensor([[1, 0, 0, 0, 0, 0, 0.0]],
                         device=device).repeat(B, 1)
    app = torch.zeros((B, 2), device=device)
    state = field.TrainState(
        splats=splats, poses=poses, app_ab=app,
        splat_opt=make_splat_optimizer(cfg, 1.0).init(splat_params(splats)),
        pose_opt=make_pose_optimizer(cfg).init({"poses": poses}),
        app_opt=make_app_optimizer().init({"app_ab": app}),
        stats=DensifyStats.zeros(splats.capacity, device=device), step=0)

    def stack(shape):
        return torch.from_numpy(rng.uniform(0, 1, (B,) + shape).astype(
            np.float32)).to(device)
    gt, gray, prior, lang = (stack((3, H, W)), stack((1, H, W)),
                             stack((3, H, W)), stack((3, H, W)))
    seg = torch.from_numpy(rng.integers(0, 4, (B, H, W))).to(device)
    near_gray = stack((1, H, W))
    ones = torch.ones((H, W), dtype=torch.bool, device=device)
    batches = [field.CameraBatch(
        cam_idx=i, uid=i, w2c=eye, gt_image=gt[i], gt_gray=gray[i],
        normal_prior=prior[i], normal_mask=ones, lang_feat=lang[i],
        lang_mask=ones, seg=seg[i], near_idx=(i + 1) % B, near_w2c=eye,
        near_gt_gray=near_gray[i], has_near=True,
        bg=torch.zeros(3, device=device)) for i in range(B)]
    gen = torch.Generator(device).manual_seed(0)
    samples = [field.draw_step_samples(cfg, flags, H, W, splats.capacity,
                                       gen, device) for _ in range(B)]
    return (cfg, flags, rcfg, cam, 1.0), state, batches, samples


def _dryrun_rank(rank, world, store, shape, device):
    """The dry run's surfaces on one rank: the field step on a data mesh
    of every rank; the DiT steps on the (data, model) mesh ``shape`` from
    weights that rank 0 draws and broadcasts; the SP forward against the
    unsharded one."""
    args, state, batches, samples = field_dryrun_inputs(world, "cpu")
    r = field_step_rank(rank, world, store, device, args, state, batches,
                        samples, 3)
    out = {"field": r["metrics"]["total"]}
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
    sp_mesh = make_mesh(world, 1, device=mesh.device)
    model = CogVideoXTransformer(TINY_SP, device=mesh.device)
    init_random_(model, torch.Generator(mesh.device).manual_seed(0))
    rng = np.random.default_rng(2)
    inputs = (_t(rng.normal(size=(1, 3, 8, 8, 12)).astype(np.float32),
                  mesh.device),
              _t(rng.normal(size=(1, 5, 16)).astype(np.float32),
                  mesh.device),
              torch.tensor([100], device=mesh.device))
    with torch.no_grad():
        ref = model(*inputs)
        with sequence_parallel(sp_mesh):
            got = model(*inputs)
    out["sp"] = float((got - ref).abs().max())
    return out


def dryrun(world: int = 4, device=None, timeout: float = SPAWN_TIMEOUT,
           workdir: Optional[str] = None) -> dict:
    """The dry run's surfaces on ``world`` gloo ranks on ``device``
    (the card by default, which raises without one; the tiny models run
    on the CPU only, so pass ``device="cpu"``): the view-parallel field
    step (one view per rank), one full fine-tune step and one LoRA step of
    the tiny DiT on a (data = world / 2, model = 2) mesh, and the tiny
    DiT's forward through the ring over every rank. Raises unless every
    rank reports the same finite losses and the ring forward is within
    ``SP_ATOL`` of the unsharded one. Returns rank 0's results."""
    dev = resolve_device(device)
    if dev.type != "cpu":
        raise ValueError(f"the dry run's tiny models (the DiT's head dim "
                         f"16) run on the CPU only, not on {dev}: the "
                         f"attention kernels take head dim 64; pass "
                         f"device='cpu'")
    n_model = 2 if world % 2 == 0 else 1
    shape = (world // n_model, n_model)
    res = spawn(_dryrun_rank, world, (shape, str(dev)), timeout, workdir)
    for kind in ("field", "dit", "lora", "sp"):
        if kind == "sp":
            err = max(r["sp"] for r in res)
            if not err <= SP_ATOL:
                raise AssertionError(f"dryrun sp: ring vs unsharded {err}")
            print(f"dryrun sp ring (seq over {world} ranks) OK: "
                  f"max|ring - dense|={err:.2e}")
            continue
        losses = {r[kind] for r in res}
        if len(losses) != 1 or not np.isfinite(res[0][kind]):
            raise AssertionError(f"dryrun {kind}: rank losses {losses}")
        where = (f"data={world}" if kind == "field"
                 else f"data={shape[0]}, model={shape[1]}")
        print(f"dryrun {kind} ({where}) OK: loss={res[0][kind]:.4f}")
    return res[0]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--world", type=int, default=4)
    p.add_argument("--device", default=None,
                   help="torch device (default: the first CUDA card; the "
                        "tiny models run with --device cpu only)")
    args = p.parse_args(argv)
    dryrun(args.world, args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
