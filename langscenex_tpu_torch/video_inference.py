"""TriMap video generation CLI (stage 1).

Port of the JAX ``langscenex_tpu/video_inference.py``: build the
interpolation pipeline (bf16 DiT and VAE on the GPU), optionally load a
fine-tuned checkpoint, generate a 49-frame 480×720 video from (first,
last) keyframes and a prompt with 50 DDIM steps and guidance 6 (seed 42),
and write the frames.

Usage:
  python -m langscenex_tpu_torch.video_inference \\
      --first_image a.png --last_image b.png --prompt "..." \\
      --output_path out/ [--checkpoint weights.pt] [--tiny --device cpu]

``--checkpoint`` is a ``torch.save``d dict ``{"transformer": state_dict,
"vae": state_dict}`` in diffusers' keys (either entry may be missing; the
other model then keeps its seeded random weights). Without one the models
run with seeded random weights. ``--t5`` raises until the T5 encoder is
ported; the text stream is the hash-embedding stub. ``--seed`` seeds the
noise only. ``--tiny`` runs on the CPU only (``--device cpu``): its head
dim 16 and f32 attention are outside what the GPU kernels take.
"""
from __future__ import annotations

import argparse
import dataclasses
import logging
import os
import time
from typing import Optional

import numpy as np
import torch

from .models.cogvideox.datasets import load_image
from .models.cogvideox.pipeline import InterpolationPipeline, PipelineConfig
from .models.cogvideox.scheduler import DDIMScheduler
from .models.cogvideox.transformer import (CogVideoXTransformer,
                                           TransformerConfig, init_random_)
from .models.cogvideox.vae import (AutoencoderKL3D, VAEConfig,
                                   spatial_tile_decode)
from .models.t5 import TextEncoder
from .utils.device import resolve_device
from .utils.png import write_png

log = logging.getLogger(__name__)

TINY_TRANSFORMER = TransformerConfig(
    num_layers=2, num_heads=2, head_dim=16, in_channels=8, out_channels=4,
    text_embed_dim=64, time_embed_dim=32, attn_dtype=torch.float32)
TINY_VAE = VAEConfig(block_out_channels=(8, 16, 16, 32), layers_per_block=1,
                     latent_channels=4, norm_groups=4)
TINY_PIPELINE = PipelineConfig(num_frames=9, height=64, width=96,
                               num_inference_steps=4, latent_channels=4,
                               vae_scaling_factor=1.0)


def save_video_frames(video: np.ndarray, out_dir: str, fps: int = 8) -> None:
    """[T,3,H,W] in [-1,1] -> out_dir/%04d.png (and video.mp4 when ffmpeg
    is on the PATH)."""
    import shutil
    import subprocess

    os.makedirs(out_dir, exist_ok=True)
    for t in range(video.shape[0]):
        img = np.clip((video[t].transpose(1, 2, 0) + 1) / 2, 0, 1)
        write_png(os.path.join(out_dir, f"{t + 1:04d}.png"),
                  (img * 255).astype(np.uint8))
    if shutil.which("ffmpeg"):
        subprocess.run(
            ["ffmpeg", "-y", "-framerate", str(fps), "-i",
             os.path.join(out_dir, "%04d.png"),
             os.path.join(out_dir, "video.mp4")],
            check=False, capture_output=True)


def materialize(module: torch.nn.Module, dtype: torch.dtype,
                device: torch.device, generator: torch.Generator):
    """A module built on the meta device, allocated in ``dtype`` on
    ``device`` and given seeded random weights."""
    module = module.to(dtype=dtype).to_empty(device=device)
    init_random_(module, generator)
    return module.eval().requires_grad_(False)


def build_pipeline(checkpoint: Optional[str] = None,
                   t5_path: Optional[str] = None, tiny: bool = False,
                   pcfg_overrides: Optional[dict] = None,
                   decode_tile: int = 16,
                   device: torch.device | str | None = None):
    """DiT + VAE + scheduler + text encoder on ``device`` (the GPU unless
    the caller names another), random weights from seed 42 as in the JAX
    package. Returns (pipeline, text encoder, pipeline config,
    {"vae_decode", "dit", "vae"}). The full configuration runs bf16
    weights and activations with the tiled decode; ``tiny`` runs a small
    f32 model with the whole decode, on the CPU only: its head dim 16 and
    f32 attention are outside what kernels K5 and K8 take."""
    dev = resolve_device(device)
    if tiny and dev.type != "cpu":
        raise ValueError(
            f"the tiny model (head dim 16, f32) runs on the CPU only, not "
            f"on {dev}: kernels K5 and K8 take head dim 64 in bf16; pass "
            f"device='cpu' (--device cpu)")
    if tiny:
        tcfg, vcfg, pcfg = TINY_TRANSFORMER, TINY_VAE, TINY_PIPELINE
        act_dt = torch.float32
    else:
        tcfg, vcfg, pcfg = TransformerConfig(), VAEConfig(), PipelineConfig()
        act_dt = torch.bfloat16
    if pcfg_overrides:
        pcfg = dataclasses.replace(pcfg, **pcfg_overrides)

    gen = torch.Generator(device=dev).manual_seed(42)
    dit = materialize(CogVideoXTransformer(tcfg, device="meta"), act_dt,
                      dev, gen)
    vae = materialize(AutoencoderKL3D(vcfg, device="meta"), act_dt, dev,
                      gen)
    if checkpoint:
        state = torch.load(checkpoint, map_location=dev, weights_only=True)
        unknown = set(state) - {"transformer", "vae"}
        if unknown:
            raise KeyError(f"checkpoint entries {sorted(unknown)}: expected "
                           f"'transformer' and/or 'vae'")
        if "transformer" in state:
            dit.load_state_dict(state["transformer"])
        if "vae" in state:
            vae.load_state_dict(state["vae"])

    def denoiser(lat, txt, t):
        return dit(lat.to(act_dt), txt.to(act_dt), t)

    def vae_encode(imgs):
        return vae.encode(imgs.to(act_dt))[0]

    def decode_one(z):
        return vae.decode(z.to(act_dt)).float()

    if tiny:
        vae_decode = decode_one
    else:
        # tiled decode (the reference's enable_tiling): the whole 49-frame
        # decode's activations would sit beside the resident DiT
        ov = max(4, decode_tile // 4)

        def vae_decode(z):
            return spatial_tile_decode(decode_one, z, tile=decode_tile,
                                       overlap=ov)

    text = TextEncoder(t5_path, embed_dim=tcfg.text_embed_dim)
    pipe = InterpolationPipeline(denoiser, vae_encode, vae_decode,
                                 DDIMScheduler(), pcfg)
    return pipe, text, pcfg, {"vae_decode": vae_decode, "dit": dit,
                              "vae": vae}


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO)
    p = argparse.ArgumentParser()
    p.add_argument("--first_image", required=True)
    p.add_argument("--last_image", required=True)
    p.add_argument("--prompt", default="")
    p.add_argument("--negative_prompt", default="")
    p.add_argument("--output_path", required=True)
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--t5", default=None)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--num_inference_steps", type=int, default=50)
    p.add_argument("--guidance_scale", type=float, default=6.0)
    p.add_argument("--fps", type=int, default=8)
    p.add_argument("--device", default=None,
                   help="torch device (default: the first CUDA card)")
    p.add_argument("--tiny", action="store_true",
                   help="tiny random model (pipeline smoke test; CPU only, "
                        "with --device cpu)")
    p.add_argument("--report", action="store_true",
                   help="print a JSON line: wall time, peak device memory, "
                        "VAE-decode ms/frame")
    p.add_argument("--decode-tile", type=int, default=16,
                   help="VAE spatial tile size in latent pixels (16 = 128 "
                        "px output tiles)")
    p.add_argument("--broadcast_interval", type=int, default=1,
                   help="training-free DiT output broadcast: >1 reuses the "
                        "guided noise prediction for this many steps in the "
                        "middle of the trajectory")
    args = p.parse_args(argv)

    overrides = {"guidance_scale": args.guidance_scale,
                 "broadcast_interval": args.broadcast_interval}
    if not args.tiny:
        # tiny mode keeps its own 4-step schedule
        overrides["num_inference_steps"] = args.num_inference_steps
    pipe, text, pcfg, aux = build_pipeline(
        args.checkpoint, args.t5, args.tiny, pcfg_overrides=overrides,
        decode_tile=args.decode_tile, device=args.device)
    dev = next(aux["dit"].parameters()).device
    hw = (pcfg.height, pcfg.width)
    first = torch.from_numpy(load_image(args.first_image, hw))[None].to(dev)
    last = torch.from_numpy(load_image(args.last_image, hw))[None].to(dev)
    cond = torch.from_numpy(text.encode([args.prompt])).to(dev)
    uncond = torch.from_numpy(text.encode([args.negative_prompt])).to(dev)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    video = pipe(first, last, cond, uncond, generator=gen).cpu().numpy()
    t_video = time.perf_counter() - t0
    save_video_frames(video[0], args.output_path, args.fps)
    log.info("wrote %d frames to %s", video.shape[1], args.output_path)
    if args.report:
        import json
        rec = {"device": str(dev), "wall_s": t_video,
               "frames": int(video.shape[1]),
               "steps": int(pcfg.num_inference_steps)}
        if dev.type == "cuda":
            rec["device_name"] = torch.cuda.get_device_name(dev)
            rec["peak_bytes_allocated"] = torch.cuda.max_memory_allocated(dev)
        z = torch.zeros((1, pcfg.latent_frames, pcfg.latent_channels,
                         pcfg.latent_height, pcfg.latent_width), device=dev)
        with torch.inference_mode():
            t0 = time.perf_counter()
            aux["vae_decode"](z).cpu()
            rec["vae_decode_ms_per_frame"] = (
                (time.perf_counter() - t0) * 1e3 / pcfg.num_frames)
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
