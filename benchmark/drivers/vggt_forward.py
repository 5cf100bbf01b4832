"""Driver of the VGGT cells: the port's pose estimator forward
(``pose_estimation.run_vggt``: the aggregator, the camera head and the
depth head, as the reference's VGGTEstimator runs them) with VGGT at the
configuration's widths and precision, one clip of ``num_frames`` frames a
forward.

Set-up builds ``VGGTConfig`` from the configuration's keys (its
``dtype`` among them), copies the seeded weights into the port's module,
makes the traffic's clips on the device and runs ``warm_forwards``
forwards. The window runs forwards back to back over the clips in turn
until its seconds run out; the forwards completed over its time are the
cell's ``trimap_step_ms`` (one forward is its unit). The check follows
the window's first forward (clip 0): its pose encoding, depth, depth
confidence and the aggregator's last layer of tokens against the
reference's forward, and two global blocks alone: the last against the
reference's block on the program's own input to it, and block
``WITNESS`` run by the program after the window on the input that the
reference's own forward brings to it, against the reference's block on
that input. A fault in one block's attention that moves its output well
above bf16 rounding (one frame's keys left out) can move the forward's
outputs by less than the rounding carried through 72 blocks; a block
alone shows it, and the two blocks take their input from the two sides.
"""
from __future__ import annotations

import torch

from benchmark.harness import trace
from benchmark.inputs import vggt as vggt_inputs
from benchmark.reference import vggt as vggt_ref

# VGGTConfig's fields that the configuration's file gives
CONFIG_KEYS = ("img_size", "patch_size", "embed_dim", "depth", "num_heads",
               "mlp_ratio", "num_register_tokens", "qk_norm", "rope_freq",
               "layerscale_init", "vit_embed_dim", "vit_depth",
               "vit_num_heads", "vit_layerscale_init", "camera_trunk_depth",
               "camera_iterations", "intermediate_layers", "dpt_features",
               "dpt_out_channels", "dtype")
OUTPUTS = ("pose_enc", "depth", "depth_conf")
# the global block that the reference's input is fed to: the last of the
# tier-1 tests' 2 + 2 cut
WITNESS = 1


def rel_rms(x: torch.Tensor, ref: torch.Tensor, base: torch.Tensor) -> float:
    """|x - ref| / |base| over every entry, inf where the shapes differ."""
    if x is None or x.shape != ref.shape:
        return float("inf")
    return float(torch.linalg.norm(x.float() - ref)
                 / torch.linalg.norm(base))


class Driver:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.cfg, self.traffic, self.seed = config, traffic, seed
        self.dev = torch.device(device)
        self.records = {}
        self.seen = {}

    def setup(self) -> None:
        from langscenex_tpu_torch.models.vggt import VGGT, VGGTConfig
        from langscenex_tpu_torch.pose_estimation import run_vggt
        cfg, dev = self.cfg, self.dev
        if cfg["head_dtype"] != "float32":
            raise ValueError(f"head_dtype {cfg['head_dtype']!r}: the "
                             f"port runs VGGT's heads in float32")
        vcfg = VGGTConfig(**{k: tuple(cfg[k]) if isinstance(cfg[k], list)
                             else cfg[k] for k in CONFIG_KEYS},
                          enable_point_head=False)
        model = VGGT(vcfg, device=dev).eval().requires_grad_(False)
        params = model.state_dict()
        names = set()
        for name, t in vggt_inputs.weights(cfg, self.seed, dev):
            params[name].copy_(t)
            names.add(name)
        if names != set(params):
            raise KeyError(f"weights and module differ: "
                           f"{sorted(names ^ set(params))[:5]}")
        self.model, self.run = model, run_vggt
        self.clips = [vggt_inputs.clip(cfg, self.traffic, self.seed, i, dev)
                      for i in range(self.traffic["clips"])]
        self.recording = False
        self.rope = None
        agg = model.aggregator
        inner = agg.forward

        def aggregate(images):
            inters, hw, ns = inner(images)
            if self.recording:
                self.seen["tokens"] = inters[cfg["depth"] - 1].float().clone()
            return inters, hw, ns
        agg.forward = aggregate
        last = agg.global_blocks[-1]
        inner_block = last.forward

        def global_block(x, rope=None):
            self.rope = rope
            out = inner_block(x, rope)
            if self.recording:
                C = x.shape[-1]
                self.seen["block_in"] = x.reshape(1, -1, C).float().clone()
                self.seen["block_out"] = out.reshape(1, -1, C).float().clone()
            return out
        last.forward = global_block
        for i in range(self.traffic["warm_forwards"]):
            self._forward(i)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def _forward(self, i: int) -> None:
        """Forward ``i`` of a run, on clip i mod the clips; the first while
        recording keeps its outputs."""
        out = self.run(self.model, self.clips[i % len(self.clips)])
        if self.recording:
            self.seen.update({k: out[k][None].float().clone()
                              for k in OUTPUTS})
            self.recording = False

    def window(self, seconds: float, clock) -> int:
        t_end = clock() + seconds
        self.recording = True
        n = 0
        while n == 0 or clock() < t_end:
            self._forward(n)
            n += 1
        return n

    def traced(self) -> trace.Trace:
        n = self.traffic["traced_units"]

        def run():
            self.recording = True
            for i in range(n):
                self._forward(i)
            return n
        return trace.take(run, self.records)

    def failed(self) -> int:
        return 0

    def release(self) -> dict:
        """The recorded forward's results, and the witness block's output
        on the reference's input; then the program's state is freed."""
        prog = dict(self.seen)
        if self.model is not None and self.seen:
            prog.update(self._witness())
        self.model = None
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()
        return prog

    def _witness(self) -> dict:
        """Global block WITNESS through the program's own path (the
        aggregator's global step, under the forward's autocast and RoPE
        tables) on the tokens that the reference's f32 forward of clip 0
        brings to it."""
        cfg = self.cfg
        params = dict(vggt_inputs.weights(cfg, self.seed, self.dev))
        x = vggt_ref.global_input(params, cfg, WITNESS, self.clips[0][None])
        del params
        agg, S = self.model.aggregator, cfg["num_frames"]
        with torch.no_grad(), torch.autocast(
                "cuda", torch.bfloat16, enabled=self.dev.type == "cuda"):
            out = agg._global(agg.global_blocks[WITNESS],
                              x.reshape(S, x.shape[1] // S, -1), 1, S,
                              self.rope)
        return dict(witness_in=x, witness_out=out.reshape(x.shape).float())

    def reference(self, prog: dict, precision: str = "f32") -> dict:
        """The reference's forward of clip 0 on the seeded weights, its
        last global block on the program's input to that block, and its
        block WITNESS on its own input to that block."""
        params = dict(vggt_inputs.weights(self.cfg, self.seed, self.dev))
        ref = vggt_ref.forward(params, self.cfg, self.clips[0][None],
                               precision)
        for key, i in (("block", self.cfg["depth"] - 1),
                       ("witness", WITNESS)):
            x = prog.get(key + "_in") if prog else None
            if x is not None:
                ref[key + "_in"] = x
                ref[key] = vggt_ref.global_block(params, self.cfg, i, x,
                                                 precision)
        return ref

    def readings(self, prog: dict, ref: dict) -> dict:
        """The relative RMS difference from the reference's of the pose
        encoding, the depth and the depth confidence, and that of the last
        layer's tokens relative to the reference's change over the
        aggregator's blocks (its output less [input, input]), and those of
        the last global block's output and of block WITNESS's relative to
        the reference block's change (inf where the program ran no such
        block)."""
        out = {f"{k}_rel_rms": rel_rms(prog.get(k), ref[k], ref[k])
               for k in OUTPUTS}
        base = ref["tokens"] - ref["tokens_in"].repeat(1, 1, 1, 2)
        out["tokens_rel_rms"] = rel_rms(prog.get("tokens"), ref["tokens"],
                                        base)
        for name, key, out_key in (
                ("global_block_rel_rms", "block", "block_out"),
                ("ref_fed_block_rel_rms", "witness", "witness_out")):
            out[name] = rel_rms(prog.get(out_key), ref[key],
                                ref[key] - ref[key + "_in"]) \
                if key in ref else float("inf")
        return out

    def as_program(self, ref: dict) -> dict:
        """A reference's result in the program's place (the control)."""
        out = {k: ref[k] for k in OUTPUTS + ("tokens",)}
        for key in ("block", "witness"):
            if key in ref:
                out.update({key + "_in": ref[key + "_in"],
                            key + "_out": ref[key]})
        return out

    def close(self) -> None:
        pass


def make(config, traffic, seed, device):
    return Driver(config, traffic, seed, device)


def plant(name: str):
    """A fault planted in the program's timed path; returns a function that
    removes it."""
    from langscenex_tpu_torch.models import vggt
    Agg = vggt.Aggregator
    frame, glob = Agg._frame, Agg._global
    if name == "frame_as_global":
        # the global blocks attend within each frame
        def _global(self, blk, tokens, B, S, rope):
            return frame(self, blk, tokens, rope)
        Agg._global = _global
    elif name == "frame_dropped":
        # one frame's keys (the middle one's) left out of the global
        # attention
        def _global(self, blk, tokens, B, S, rope):
            T, s = tokens.shape[1], S // 2
            attend = vggt.flash_attention

            def dropped(q, k, v, *a, **kw):
                def keep(t):
                    return torch.cat([t[:, :, :s * T], t[:, :, (s + 1) * T:]],
                                     2)
                return attend(q, keep(k), keep(v), *a, **kw)
            vggt.flash_attention = dropped
            try:
                return glob(self, blk, tokens, B, S, rope)
            finally:
                vggt.flash_attention = attend
        Agg._global = _global
    elif name == "unchanged":
        # every frame and global block leaves its tokens as they came
        Agg._frame = lambda self, blk, tokens, rope: tokens
        Agg._global = lambda self, blk, tokens, B, S, rope: tokens
    else:
        raise ValueError(name)

    def remove():
        Agg._frame, Agg._global = frame, glob
    return remove


FAULTS = ("frame_as_global", "frame_dropped", "unchanged")
