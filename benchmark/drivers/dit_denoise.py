"""Driver of the TriMap cells: the port's classifier-free-guided denoise
loop (``models/cogvideox/pipeline.denoise_loop``, as
``InterpolationPipeline.__call__`` runs it) with the CogVideoX DiT at the
configuration's widths, one request from step 0 of the schedule.

Set-up loads the seeded bf16 weights into the port's module, makes the
request's latents and prompt embeddings and runs the loop's first step
once. The window runs the loop from step 0 until its seconds run out;
the steps completed over its time are the cell's ``trimap_step_ms``. The
check compares two of the window's steps with the reference's: step 0,
from the seeded noise, and a step drawn from the seed among the first
``check_within`` (the window always completes it), taken from the
latents the program had before it.
"""
from __future__ import annotations

import torch

from benchmark.harness import trace
from benchmark.inputs import dit as dit_inputs
from benchmark.reference import dit as dit_ref



class StopWindow(Exception):
    pass


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class Driver:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.cfg, self.traffic, self.seed = config, traffic, seed
        self.dev = torch.device(device)
        self.records = {}
        # the later step the check follows, drawn from the seed
        self.later = 1 + seed % (traffic["check_within"] - 1)
        self.seen = {}

    def setup(self) -> None:
        from langscenex_tpu_torch.models.cogvideox.pipeline import (
            PipelineConfig, denoise_loop)
        from langscenex_tpu_torch.models.cogvideox.scheduler import \
            DDIMScheduler
        from langscenex_tpu_torch.models.cogvideox.transformer import (
            CogVideoXTransformer, TransformerConfig)
        cfg, dev = self.cfg, self.dev
        dt = getattr(torch, cfg["dtype"])
        tcfg = TransformerConfig(**{k: cfg[k] for k in (
            "num_layers", "num_heads", "head_dim", "in_channels",
            "out_channels", "patch_size", "text_embed_dim",
            "time_embed_dim", "use_rotary")})
        self.pcfg = PipelineConfig(**{k: cfg[k] for k in (
            "num_frames", "height", "width", "num_inference_steps",
            "guidance_scale", "vae_scale_factor_spatial",
            "vae_scale_factor_temporal", "latent_channels",
            "broadcast_interval")})
        model = CogVideoXTransformer(tcfg, device="meta").to(dtype=dt)
        model.load_state_dict(dit_inputs.weights(cfg, self.seed, dev, dt),
                              strict=True, assign=True)
        self.model = model.eval().requires_grad_(False)
        self.req = dit_inputs.request(cfg, self.seed, dev)
        self.scheduler = DDIMScheduler()
        self.loop = denoise_loop

        def denoiser(lat, txt, t):
            out = self.model(lat.to(dt), txt.to(dt), t)
            if self.recording:
                self.calls += 1
                if self.calls - 1 in (0, self.later):
                    self.seen[f"out{self.calls - 1}"] = out.float().clone()
            return out
        self.denoiser = denoiser
        self.recording = False
        self._run(lambda n: n >= 1)
        _sync(dev)

    def _run(self, stop) -> int:
        """The loop from step 0 until ``stop(n)`` after the n-th step; while
        recording, the DiT outputs and the latents around the checked
        steps are kept."""
        n = [0]
        self.calls = 0

        def cb(i, t, evaluated, latents):
            n[0] += 1
            if self.recording and i in (0, self.later - 1, self.later):
                self.seen[f"latents{i}"] = latents.clone()
            if stop(n[0]):
                raise StopWindow
        r = self.req
        with torch.inference_mode():
            try:
                self.loop(self.denoiser, r["noise"], r["image"], r["cond"],
                          r["uncond"], self.scheduler, self.pcfg, cb)
            except StopWindow:
                pass
        return n[0]

    def window(self, seconds: float, clock) -> int:
        self.recording = True
        t_end = clock() + seconds
        try:
            return self._run(lambda n: clock() >= t_end
                             and n > self.later)
        finally:
            self.recording = False

    def traced(self) -> trace.Trace:
        from langscenex_tpu_torch.models.cogvideox import transformer as tm
        restore = [trace.wrap(tm, "attention_bthd", "bench.attention"),
                   trace.wrap(tm, "ln_modulate", "bench.ln_modulate"),
                   trace.wrap(torch.nn.Linear, "forward", "bench.linear")]
        n = max(self.traffic["traced_units"], self.later + 1)
        self.recording = True
        try:
            return trace.take(lambda: self._run(lambda k: k >= n),
                              self.records)
        finally:
            self.recording = False
            for r in restore:
                r()

    def failed(self) -> int:
        return 0

    def release(self) -> dict:
        prog = dict(self.seen)
        self.model = None
        self.denoiser = None
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()
        return prog

    def reference(self, prog: dict, precision: str = "f32") -> dict:
        """The reference's step 0 from the seeded noise and its later step
        from the program's latents before it."""
        params = dit_inputs.weights(self.cfg, self.seed, self.dev,
                                    getattr(torch, self.cfg["dtype"]))
        k = self.later
        start = prog.get(f"latents{k - 1}") if prog else None
        if start is None:
            start = self.req["noise"]
        return dict(first=dit_ref.step(params, self.cfg, self.req, 0,
                                       self.req["noise"], precision),
                    later=dit_ref.step(params, self.cfg, self.req, k,
                                       start.float(), precision))

    def readings(self, prog: dict, ref: dict) -> dict:
        """For step 0 and the later step: the DiT output's relative RMS
        difference from the reference's over both halves of the guided
        batch, the same of the guidance term (the cond half's output less
        the uncond half's), and the latents' after the step relative to
        the reference step's change."""
        out = {}
        k = self.later
        for name, i, r in (("", 0, ref["first"]), ("later_", k,
                                                   ref["later"])):
            o, x = prog.get(f"out{i}"), prog.get(f"latents{i}")
            keys = [name + n for n in ("dit_rel_rms", "guidance_rel_rms",
                                       "step_rel_rms")]
            if (o is None or x is None or o.shape != r["out"].shape
                    or x.shape != r["latents"].shape):
                out.update(dict.fromkeys(keys, float("inf")))
                continue
            un, co = o.chunk(2, 0)
            ru, rc = r["out"].chunk(2, 0)
            out[name + "dit_rel_rms"] = float(
                torch.linalg.norm(o - r["out"]) / torch.linalg.norm(r["out"]))
            out[name + "guidance_rel_rms"] = float(
                torch.linalg.norm((co - un) - (rc - ru))
                / torch.linalg.norm(rc - ru))
            out[name + "step_rel_rms"] = float(
                torch.linalg.norm(x.float() - r["latents"])
                / torch.linalg.norm(r["latents"] - r["x"]))
        return out

    def as_program(self, ref: dict) -> dict:
        """A reference's result in the program's place (the control)."""
        out = {}
        for i, r in ((0, ref["first"]), (self.later, ref["later"])):
            out[f"out{i}"], out[f"latents{i}"] = r["out"], r["latents"]
        return out

    def close(self) -> None:
        pass


def make(config, traffic, seed, device):
    return Driver(config, traffic, seed, device)


def plant(name: str):
    """A fault planted in the program's timed path; returns a function that
    removes it."""
    from langscenex_tpu_torch.models.cogvideox import scheduler
    from langscenex_tpu_torch.models.cogvideox import transformer as tm
    if name == "unchanged":
        inner = scheduler.DDIMScheduler.step

        def step(self, model_out, t, t_prev, sample):
            return sample.clone()
        scheduler.DDIMScheduler.step = step
        return lambda: setattr(scheduler.DDIMScheduler, "step", inner)
    if name == "half_batch":
        # one half of the guided batch computed, its output kept in shape
        inner = tm.CogVideoXTransformer.forward

        def forward(self, latents, text, timestep):
            o = inner(self, latents[1:], text[1:], timestep[1:])
            return torch.cat([o] * latents.shape[0], 0)
        tm.CogVideoXTransformer.forward = forward
        return lambda: setattr(tm.CogVideoXTransformer, "forward", inner)
    if name == "altered":
        inner = tm.CogVideoXTransformer.head

        def head(self, joint, temb, text_len, shape):
            out = inner(self, joint, temb, text_len, shape).clone()
            out[:, shape[1] // 2] = 0
            return out
        tm.CogVideoXTransformer.head = head
        return lambda: setattr(tm.CogVideoXTransformer, "head", inner)
    raise ValueError(name)


FAULTS = ("unchanged", "half_batch", "altered")
