"""DiT fine-tune CLI.

Port of the JAX ``langscenex_tpu/finetune.py``:

    python -m langscenex_tpu_torch.finetune --data /path/to/frame_dirs \\
        --steps 1000 [--lora --rank 16] [--vae vae.pt] [--device cuda:0]

``--data`` holds one subdirectory of frames per video (the contract of
``models/cogvideox/datasets.VideoClipDataset``). Latents come from the
real 3D causal VAE when ``--vae`` names a ``torch.save``d VAE state_dict
(bare, or the ``"vae"`` entry of the ``{"transformer", "vae"}`` dict that
``video_inference --checkpoint`` takes), scaled by the pipeline's
``vae_scaling_factor`` so that fine-tune latents match inference
latents. Without ``--vae`` a deterministic space-to-depth stub encoder
keeps the loop runnable for smoke tests, with a RuntimeWarning, since a
DiT fine-tuned on stub latents is useless against the real VAE.
Conditioning latents follow the interpolation pipeline: first and last
frame encoded, middle zero, concatenated on channels.

The DiT starts from seeded random weights (seed 0; the JAX package
initialises from its key 0) in f32, with f32 latents; attention runs in
bf16 through kernels K5 and K7. It runs on the first CUDA card unless
``--device`` names another. ``--tiny`` runs a small f32 model on the CPU
only (its head dim 16 is outside K5 and K7) and refuses a CUDA device.
``--t5`` names a Hugging Face T5 checkpoint directory
(``models/t5.TextEncoder``: the encoder runs on the same device; a
prompt needs its tokenizer, which needs ``transformers``); without it the
text stream is the hash-embedding stub. Checkpoints are ``torch.save``d states under
``--out`` (``train/checkpoint.py``).
"""
from __future__ import annotations

import argparse
import os
import warnings
from typing import Optional

import numpy as np
import torch

from .models.cogvideox.datasets import ClipSamplerConfig, VideoClipDataset
from .models.cogvideox.transformer import (CogVideoXTransformer,
                                           TransformerConfig)
from .models.cogvideox.vae import AutoencoderKL3D, VAEConfig
from .models.t5 import TextEncoder
from .train.checkpoint import save_checkpoint
from .train.dit import DiTTrainConfig, make_dit_train_step
from .train.lora import LoRAConfig, make_lora_train_step
from .utils.device import resolve_device
from .video_inference import materialize

TINY_TRANSFORMER = TransformerConfig(
    num_layers=2, num_heads=4, head_dim=16, in_channels=32, out_channels=16,
    patch_size=2, text_embed_dim=64, time_embed_dim=32,
    attn_dtype=torch.float32)
TINY_VAE = VAEConfig(block_out_channels=(8, 16, 16, 32), layers_per_block=1,
                     norm_groups=4)


def stub_encode(clip: np.ndarray, latent_channels: int = 16) -> np.ndarray:
    """[F,3,H,W] in [-1,1] -> [F',16,H/8,W/8]: every 4th frame, 8x8
    space-to-depth averaged into 16 channels. A deterministic stand-in
    for the VAE encoder so the trainer runs without checkpoints."""
    F, C, H, W = clip.shape
    x = clip[np.arange(0, F, 4)]                            # [F',3,H,W]
    Fp = x.shape[0]
    x = x.reshape(Fp, C, H // 8, 8, W // 8, 8)
    x = x.transpose(0, 1, 3, 5, 2, 4).reshape(Fp, C * 64, H // 8, W // 8)
    g = (C * 64) // latent_channels
    return x[:, :g * latent_channels].reshape(
        Fp, latent_channels, g, H // 8, W // 8).mean(2)


def make_vae_encode(vae_state: dict, vae_cfg: Optional[VAEConfig] = None,
                    scale: float = 0.7,
                    device: torch.device | str | None = None):
    """Real-VAE encode_fn over ``AutoencoderKL3D.encode`` with the given
    state_dict (f32, on ``device``): [F,3,H,W] in [-1,1] -> [F',16,h,w]
    latents, the posterior mean × the scaling factor (the deterministic
    choice the interpolation pipeline makes for its conditioning
    latents)."""
    dev = resolve_device(device)
    vae = AutoencoderKL3D(vae_cfg or VAEConfig(), device="meta")
    vae = vae.to_empty(device=dev).eval().requires_grad_(False)
    vae.load_state_dict(vae_state)

    @torch.no_grad()
    def encode_fn(clip: np.ndarray) -> np.ndarray:
        video = torch.from_numpy(np.ascontiguousarray(clip[None])).to(
            dev, torch.float32)
        mean, _ = vae.encode(video)
        return (mean * scale)[0].cpu().numpy()

    return encode_fn


def load_vae_encode(path: str, vae_cfg: Optional[VAEConfig] = None,
                    scale: float = 0.7,
                    device: torch.device | str | None = None):
    """The real encode_fn from a ``torch.save``d VAE state_dict, bare or
    the ``"vae"`` entry of a ``{"transformer", "vae"}`` dict."""
    state = torch.load(path, map_location=resolve_device(device),
                       weights_only=True)
    if "vae" in state:
        state = state["vae"]
    return make_vae_encode(state, vae_cfg=vae_cfg, scale=scale,
                           device=device)


def build_batch(ds, text_encoder, B: int, prompt: str, encode_fn,
                device: torch.device | str | None = None) -> dict:
    """B sampled clips as {"x0", "cond", "text"} f32 tensors on
    ``device``: latents of the clip, conditioning latents (first and last
    frame encoded, zeros between) and the prompt's embedding."""
    x0s, conds = [], []
    for _ in range(B):
        clip, first, last = ds.sample()
        lat = encode_fn(clip)                               # [F',16,h,w]
        cond = np.zeros_like(lat)
        cond[0] = encode_fn(first[None])[0]
        cond[-1] = encode_fn(last[None])[0]
        x0s.append(lat)
        conds.append(cond)
    dev = resolve_device(device)
    text = text_encoder.encode([prompt] * B)
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
            for k, v in (("x0", np.stack(x0s)), ("cond", np.stack(conds)),
                         ("text", text))}


def main(argv: Optional[list] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--data", required=True,
                    help="dir of per-video frame subdirectories")
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--lr", type=float, default=1e-5)
    ap.add_argument("--frames", type=int, default=49)
    ap.add_argument("--height", type=int, default=480)
    ap.add_argument("--width", type=int, default=720)
    ap.add_argument("--prompt", default="a smooth high-quality video")
    ap.add_argument("--lora", action="store_true")
    ap.add_argument("--rank", type=int, default=16)
    ap.add_argument("--t5", default=None,
                    help="Hugging Face T5 checkpoint directory (default: "
                         "the hash-embedding stub)")
    ap.add_argument("--vae", default=None,
                    help="torch.save'd VAE state_dict (bare or the 'vae' "
                         "entry of a {transformer, vae} dict); stub encoder "
                         "otherwise")
    ap.add_argument("--vae-scale", type=float, default=0.7,
                    help="latent scaling factor (CogVideoX-5b VAE: 0.7; "
                         "must match video_inference's)")
    ap.add_argument("--out", default="./finetune_out")
    ap.add_argument("--save-every", type=int, default=500)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the first CUDA card)")
    ap.add_argument("--tiny", action="store_true",
                    help="tiny model/resolution for smoke tests (CPU only, "
                         "with --device cpu)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    if args.tiny:
        if dev.type != "cpu":
            raise ValueError(
                f"the tiny model (head dim 16) runs on the CPU only, not on "
                f"{dev}: kernels K5 and K7 take head dim 64; pass --device "
                f"cpu")
        cfg, vae_cfg = TINY_TRANSFORMER, TINY_VAE
        args.height, args.width, args.frames = 64, 96, 9
    else:
        cfg, vae_cfg = TransformerConfig(remat=True), None

    roots = sorted(os.path.join(args.data, d)
                   for d in os.listdir(args.data)
                   if os.path.isdir(os.path.join(args.data, d)))
    ds = VideoClipDataset(roots, ClipSamplerConfig(
        num_frames=args.frames, size_hw=(args.height, args.width)))
    if len(ds) == 0:
        raise SystemExit("no video dirs with enough frames under --data")
    text_encoder = TextEncoder(args.t5, embed_dim=cfg.text_embed_dim,
                               device=dev)

    if args.vae:
        encode_fn = load_vae_encode(args.vae, vae_cfg=vae_cfg,
                                    scale=args.vae_scale, device=dev)
    else:
        warnings.warn(
            "finetune: no --vae given — latents come from the "
            "space-to-depth STUB encoder. Fine for smoke tests; a DiT "
            "fine-tuned on stub latents is useless against the real VAE.",
            RuntimeWarning, stacklevel=1)
        encode_fn = stub_encode

    model = materialize(CogVideoXTransformer(cfg, device="meta"),
                        torch.float32, dev,
                        torch.Generator(device=dev).manual_seed(0))
    tcfg = DiTTrainConfig(lr=args.lr, total_steps=args.steps,
                          warmup_steps=min(100, max(1, args.steps // 10)))
    if args.lora:
        init_state, step = make_lora_train_step(model, tcfg,
                                                LoRAConfig(rank=args.rank))
        state = init_state(torch.Generator(device=dev).manual_seed(1))
    else:
        init_state, step = make_dit_train_step(model, tcfg)
        state = init_state()

    gen = torch.Generator(device=dev).manual_seed(2)
    last = {}
    for i in range(args.steps):
        batch = build_batch(ds, text_encoder, args.batch, args.prompt,
                            encode_fn, dev)
        state, metrics = step(state, batch, gen)
        if i % args.log_every == 0:
            last = {k: float(v) for k, v in metrics.items()}
            print(f"step {i}: loss={last['loss']:.4f} "
                  f"gnorm={last['grad_norm']:.3f}", flush=True)
        if args.save_every and (i + 1) % args.save_every == 0:
            save_checkpoint(args.out, state, i + 1)
    save_checkpoint(args.out, state, args.steps)
    return last


if __name__ == "__main__":
    main()
