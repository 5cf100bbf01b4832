"""Driver of the field cells: the port's ``GaussianFieldTrainer.train``
on the room at the configuration's size, from the traffic mix's first
iteration on.

Set-up builds the trainer on the seeded room and targets (as a resumed
run would hold it at that iteration: the SH degree ramped, the step
count set) and drives it through ``warm_iterations`` of ``train``
itself, which visits every camera once and settles the pair caps, so
the window finds every camera's tensors on the device and runs with the
caps it keeps. Set-up then puts the trained groups back to their seeded
values and zeroes the optimizer's moments and count: the window starts
from the seeded splats. The window calls ``train`` on, with the
trainer's own schedule, until its seconds run out; the iterations it
completed over its time are the cell's ``field_iter_ms``. The check
follows the window's first ``check_steps`` (the views and draws the
trainer made are taken from the run, none of its state), counts every
window iteration whose pair list or big-splat register overflowed, and
holds the groups the phase does not train to their seeded values.
"""
from __future__ import annotations

import dataclasses
import os
import shutil
import tempfile

import numpy as np
import torch

from benchmark.harness import trace
from benchmark.inputs import room
from benchmark.reference import field_semantic

# the loss terms of a semantic step: (reference's name, trainer's metric)
LOSS_TERMS = (("lang", "lang_loss"), ("group", "grouping_loss"),
              ("knn", "obj3d_loss"))
# the trainer's outputs at the published iterations go to a scratch
# directory (none of them falls in a window at today's speed)
SAVE_ITERATIONS = (100, 500, 1000, 2000, 5000, 10000, 12000)


class StopWindow(Exception):
    pass


class Driver:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.cfg, self.traffic, self.seed = config, traffic, seed
        self.dev = torch.device(device)
        self.first = traffic["first_iteration"]
        self.warm = traffic["warm_iterations"]
        self.n_check = traffic["check_steps"]
        self.trained = traffic["trained_groups"]
        self.frozen = [k for k in room.SCENE_KEYS if k not in self.trained]
        self.work = tempfile.mkdtemp(prefix="bench_field_")
        self.records = {}

    # ------------------------------------------------------------ set-up

    def setup(self) -> None:
        from langscenex_tpu_torch.ops.rasterize import RasterConfig
        from langscenex_tpu_torch.scene.cameras import Camera
        from langscenex_tpu_torch.scene.gaussians import GaussianState
        from langscenex_tpu_torch.train.field import GaussianFieldTrainer
        from langscenex_tpu_torch.utils.config import OptimizationConfig

        cfg, dev = self.cfg, self.dev
        lang_dir = os.path.join(self.work, "lang")
        os.makedirs(lang_dir)
        room.write_targets(cfg, self.seed, dev, lang_dir)
        img = room.image(cfg)
        fy = room.fovy(cfg)
        cams = [Camera(uid=i, colmap_id=i, R=R, T=T, fovx=cfg["fovx"],
                       fovy=fy, width=cfg["width"], height=cfg["height"],
                       image_name=room.image_name(i), image=img)
                for i, (R, T) in enumerate(room.arc_poses(cfg))]
        centres = np.stack([c.cam_center for c in cams])
        extent = 1.1 * float(np.linalg.norm(
            centres - centres.mean(0), axis=1).max())
        splats = GaussianState(**room.scene(cfg, self.seed, dev))
        tr = GaussianFieldTrainer(
            cams, splats, OptimizationConfig(**cfg["opt"]),
            scene_extent=extent, sh_degree_max=cfg["sh_degree"],
            rcfg=RasterConfig(), lang_dir=lang_dir, seed=self.seed)
        tr.active_sh_degree = cfg["sh_degree"]
        tr.state.step = self.first - 1
        self.trainer = tr

        seeded = {k: getattr(splats, k).clone() for k in self.trained}
        self._train(self.first, self.first + self.warm - 1, None)
        # back to the seeded splats: the trained groups' values, the
        # moments and the count (the check holds the other groups)
        st = tr.state
        st.splats = dataclasses.replace(st.splats, **seeded)
        for moments in (st.splat_opt.mu, st.splat_opt.nu):
            for v in moments.values():
                v.zero_()
        st.splat_opt = dataclasses.replace(st.splat_opt, count=0)
        self.next_it = self.first + self.warm
        self.check = None
        self.overflow = []

    def _train(self, first: int, last: int, callback) -> None:
        self.trainer.train(iterations=last, callback=callback,
                           save_dir=os.path.join(self.work, "out"),
                           save_iterations=SAVE_ITERATIONS,
                           checkpoint_iterations=SAVE_ITERATIONS,
                           test_iterations=SAVE_ITERATIONS,
                           first_iteration=first)

    # ------------------------------------------------------------ windows

    def _watch(self) -> None:
        """Record the views and draws the trainer makes until the checked
        steps are done."""
        tr = self.trainer
        check = self.check = {"views": [], "samples": [], "losses": []}
        batch_fn, draw_fn = tr._camera_batch, tr.draw_samples

        def batch(ci, flags):
            check["views"].append(ci)
            return batch_fn(ci, flags)

        def draw(flags):
            s = draw_fn(flags)
            check["samples"].append(s)
            return s
        tr._camera_batch, tr.draw_samples = batch, draw

    def _record(self, k: int, state, metrics) -> None:
        """Checked step k: its losses, the first step's language-feature
        moment, the language features after the last step."""
        check = self.check
        check["losses"].append({term: metrics[name]
                                for term, name in LOSS_TERMS})
        if k == 0:
            check["mu1"] = state.splat_opt.mu["language_feature"].clone()
        if k == self.n_check - 1:
            check["lang"] = state.splats.language_feature.clone()
            del self.trainer._camera_batch, self.trainer.draw_samples

    def _run(self, stop, pairs=None) -> int:
        """train on from the next iteration until ``stop(n)`` is true
        after the n-th iteration (appending each iteration's pair count to
        ``pairs`` when given); returns n. The first call records the
        checked steps and runs at least as many."""
        n = [0]
        if self.check is None:
            self._watch()
        check = self.check

        def cb(it, state, metrics):
            if "lang" not in check:
                self._record(n[0], state, metrics)
            n[0] += 1
            self.overflow.append((metrics["pair_overflow"],
                                  metrics.get("k_overflow", 0.0)))
            if pairs is not None:
                pairs.append(metrics["num_pairs"])
            if stop(n[0]) and "lang" in check:
                raise StopWindow
        try:
            self._train(self.next_it, self.trainer.cfg.iterations, cb)
        except StopWindow:
            pass
        self.next_it += n[0]
        return n[0]

    def window(self, seconds: float, clock) -> int:
        t_end = clock() + seconds
        return self._run(lambda n: clock() >= t_end)

    def traced(self) -> trace.Trace:
        from langscenex_tpu_torch.ops import losses
        from langscenex_tpu_torch.ops import rasterize_cuda as rc
        from langscenex_tpu_torch.train import optim
        blend = self.records.setdefault("blend", [])

        def k1_inputs(args, kwargs, out):
            lists, mean2d, conic, opacity, channels, gx, gy, cfg = args
            blend.append(dict(
                starts=lists.tile_starts, counts=lists.tile_counts,
                point_list=lists.point_list, mean2d=mean2d.detach(),
                conic=conic.detach(), opacity=opacity.detach(),
                n_ch=channels.shape[1], grid=(gx, gy),
                tile=(cfg.tile_w, cfg.tile_h)))
        restore = [trace.wrap(rc, "blend_forward", "bench.blend_fwd",
                              k1_inputs),
                   trace.wrap(rc, "blend_backward", "bench.blend_bwd"),
                   trace.wrap(losses, "loss_cls_3d", "bench.knn_loss"),
                   trace.wrap(optim.GroupAdam, "update", "bench.adam")]
        n = self.traffic["traced_units"]
        try:
            pairs = self.records.setdefault("num_pairs", [])
            tr = trace.take(lambda: self._run(lambda k: k >= n, pairs),
                            self.records)
        finally:
            for r in restore:
                r()
        return tr

    def failed(self) -> int:
        """Window iterations whose pair list or big-splat register
        overflowed (their renders are truncated)."""
        return self.n_overflowed

    # --------------------------------------------------------- the check

    def release(self) -> dict:
        """Free the program's state; keep what the check compares."""
        c = self.check
        splats = self.trainer.state.splats
        prog = dict(
            losses=[{k: float(v) for k, v in x.items()}
                    for x in c["losses"]],
            grad1=c["mu1"] / (1 - 0.9), lang=c["lang"],
            views=c["views"], samples=c["samples"],
            frozen={k: getattr(splats, k) for k in self.frozen})
        self.n_overflowed = sum(float(p) + float(k) > 0
                                for p, k in self.overflow)
        self.trainer = None
        self.check = None
        self.overflow = []
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()
        return prog

    def reference(self, prog: dict, precision: str = "f32") -> dict:
        cfg, dev = self.cfg, self.dev
        sp = room.scene(cfg, self.seed, dev)
        poses = room.arc_poses(cfg)
        tg = room.targets(cfg, self.seed, dev)
        H, W = cfg["height"], cfg["width"]
        views = []
        for ci, s in zip(prog["views"], prog["samples"]):
            f, seg = tg[ci]
            views.append(dict(
                w2c=torch.as_tensor(room.w2c(*poses[ci]), dtype=torch.float32,
                                    device=dev),
                lang=torch.as_tensor(room.resize_bilinear_chw(f, H, W),
                                     device=dev),
                seg=torch.as_tensor(room.resize_nearest(
                    seg.astype(np.int64), H, W), device=dev),
                group_idx=s.group_idx, obj_idx=s.obj_idx))
        cam = dict(width=W, height=H, fovx=cfg["fovx"], fovy=room.fovy(cfg),
                   tile=cfg["tile"])
        ref = field_semantic.semantic_steps(sp, views, cfg["opt"], cam,
                                            precision)
        ref["start"] = sp
        return ref

    def readings(self, prog: dict, ref: dict) -> dict:
        """The numbers the cell's limits hold: the worst relative gap over
        the checked steps of each loss term (the language map's L1, the
        grouping loss, the 3D kNN loss), the gap of the first gradient's
        norm, the gradient's relative RMS difference over every row and
        over the rows only the render's losses reach and the gap of the
        norm of the language features' change over the checked steps, and
        the largest change of a group the phase does not train, from its
        seeded value to the window's end (0: they are frozen)."""
        def gap(a, b):
            return abs(a - b) / max(abs(b), 1e-30)

        def rel_rms(a, b):
            return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))

        def moved(a, b):
            if a.shape != b.shape:
                return float("inf")
            return float((a.float() - b.float()).abs().max())
        gp, gr = prog["grad1"], ref["grad1"]
        rows = ref["render_rows"]
        start = ref["start"]["language_feature"]
        dp = float(torch.linalg.norm(prog["lang"] - start))
        dr = float(torch.linalg.norm(ref["lang"] - start))
        out = {f"{t}_loss_gap": max(gap(a[t], b[t]) for a, b in
                                    zip(prog["losses"], ref["losses"]))
               for t in ("lang", "group", "knn")}
        out.update(
            grad_norm_gap=gap(float(torch.linalg.norm(gp)),
                              float(torch.linalg.norm(gr))),
            grad_rel_rms=rel_rms(gp, gr),
            render_grad_rel_rms=rel_rms(gp[rows], gr[rows]),
            change_norm_gap=gap(dp, dr),
            frozen_change=max(moved(prog["frozen"][k], ref["start"][k])
                              for k in prog["frozen"]))
        return out

    def as_program(self, ref: dict) -> dict:
        """A reference's result in the program's place (the control)."""
        return dict(losses=ref["losses"], grad1=ref["grad1"],
                    lang=ref["lang"],
                    frozen={k: ref["start"][k] for k in self.frozen})

    def close(self) -> None:
        shutil.rmtree(self.work, ignore_errors=True)


def make(config, traffic, seed, device):
    return Driver(config, traffic, seed, device)


# --------------------------------------------------------------- faults

def plant(name: str):
    """A fault planted in the program's timed path, for the check's own
    tests and for reading a fault's numbers: returns a function that
    removes it."""
    from langscenex_tpu_torch.ops import losses
    from langscenex_tpu_torch.train import field, optim
    if name == "unchanged":
        inner = optim.GroupAdam.update

        def update(self, grads, state, params):
            _, st = inner(self, grads, state, params)
            return dict(params), st
        optim.GroupAdam.update = update
        return lambda: setattr(optim.GroupAdam, "update", inner)
    if name == "half_batch":
        inner = losses.l1_loss

        def l1(x, y):
            h = x.shape[-2] // 2
            return (x[..., :h, :] - y[..., :h, :]).abs().mean()
        losses.l1_loss = l1
        return lambda: setattr(losses, "l1_loss", inner)
    if name == "frozen_moved":
        inner = field.phase_grad_mask

        def unmasked(phase, grads):
            return dict(grads)
        field.phase_grad_mask = unmasked
        return lambda: setattr(field, "phase_grad_mask", inner)
    if name == "altered":
        inner = field.render_view

        def render(*args, **kwargs):
            out = inner(*args, **kwargs)
            if out.language is None:
                return out
            lang = out.language.clone()
            H, W = lang.shape[-2:]
            lang[:, H // 4:H // 2, W // 4:W // 2] = 0.0
            return out._replace(language=lang)
        field.render_view = render
        return lambda: setattr(field, "render_view", inner)
    raise ValueError(name)


FAULTS = ("unchanged", "half_batch", "altered", "frozen_moved")
