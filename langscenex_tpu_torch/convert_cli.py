"""Checkpoint check CLI: does a reference torch checkpoint fit the port's
full-size model?

Port of the JAX package's ``convert_cli.py``. The JAX package converts the
reference's torch state_dicts into orbax flax trees; the port loads those
checkpoints natively (``torch.load(weights_only=True)`` under the
reference's state_dict keys), so the CLI keeps only its ``--verify`` role
and writes nothing:

  python -m langscenex_tpu_torch.convert_cli --family sam2 \\
      --input sam2_hiera_large.pt --verify

The families are the JAX package's: SAM1 ViT-H (sam_vit_h_4b8939.pth),
SAM2 Hiera-L (sam2_hiera_large.pt), VGGT-1B, the CogVideoX-5B DiT and 3D
VAE (diffusers' keys), LPIPS VGG, the per-scene AE, CLIP ViT-L/14 (vision
and text towers, Hugging Face's keys) and the LSeg branch's VQ model.
:func:`expected_shapes` builds the family's full-size port module on the
``meta`` device (no memory) and lists its state_dict's shapes;
:func:`verify` reports missing keys, unexpected keys and shape drift.

Against the JAX package's ``expected_shapes`` (a flax init traced with
``jax.eval_shape``) the port's lists hold a few more values, all of them
in the reference's checkpoints: SAM1's mask-prompt branch
``prompt_encoder.mask_downscaling.*`` (4,684 values; flax creates no
module that the points-only init trace does not call), VGGT's DINOv2
``aggregator.patch_embed.mask_token`` (1,024), LPIPS's input ``shift``
and ``scale`` buffers (6) and the per-scene AE's six
``num_batches_tracked`` counters. The layouts differ (torch kernels are
[out, in], flax's [in, out]; the DiT's q, k and v are three linears in
diffusers' keys and one fused kernel in flax); the totals otherwise
equal.
"""
from __future__ import annotations

import argparse

FAMILIES = ("sam1", "sam2", "vggt", "dit", "vae", "lpips", "autoencoder",
            "clip", "clip_text", "vq")


def _model(family: str):
    """The family's full-size port module on the meta device."""
    dev = "meta"
    if family == "sam1":
        from .models.sam1 import SAM1, SAM1Config
        return SAM1(SAM1Config(), device=dev)
    if family == "sam2":
        from .models.sam2.model import SAM2, SAM2Config
        return SAM2(SAM2Config(), device=dev)
    if family == "vggt":
        from .models.vggt import VGGT, VGGTConfig
        return VGGT(VGGTConfig(), device=dev)
    if family == "dit":
        from .models.cogvideox.transformer import (CogVideoXTransformer,
                                                   TransformerConfig)
        return CogVideoXTransformer(TransformerConfig(), device=dev)
    if family == "vae":
        from .models.cogvideox.vae import AutoencoderKL3D, VAEConfig
        return AutoencoderKL3D(VAEConfig(), device=dev)
    if family == "lpips":
        from .models.lpips import LPIPS
        return LPIPS(device=dev)
    if family == "autoencoder":
        from .models.autoencoder import Autoencoder
        return Autoencoder(device=dev)
    if family == "clip":
        from .models.clip_dense import CLIPVisionConfig, CLIPVisionDense
        return CLIPVisionDense(CLIPVisionConfig(), device=dev)
    if family == "clip_text":
        from .models.clip_dense import CLIPTextConfig, CLIPTextEncoder
        return CLIPTextEncoder(CLIPTextConfig(), device=dev)
    if family == "vq":
        # the LSeg branch's semantic compressor (preprocessor.py:115-129)
        from .models.vq_model import VQConfig, VQModel
        return VQModel(VQConfig(), device=dev)
    raise ValueError(f"unknown family {family!r}; one of {FAMILIES}")


def expected_shapes(family: str) -> dict:
    """{state_dict key: shape} of the family's FULL-SIZE port module (the
    default config of every model class is the upstream checkpoint's
    size), built on the meta device: no memory, no compute."""
    return {k: tuple(v.shape) for k, v in _model(family).state_dict().items()}


def unwrap(sd: dict) -> dict:
    """The state_dict inside a training checkpoint: SAM2's ``model`` entry
    or a ``state_dict`` entry, as the JAX package's loader unwraps them."""
    if isinstance(sd, dict) and "model" in sd and all(
            not k.startswith("model") for k in sd if k != "model"):
        sd = sd["model"]
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return sd


def verify(family: str, state_dict: dict) -> list:
    """Problems of ``state_dict`` against the family's full-size module:
    missing keys, unexpected keys and shape drift (empty: it loads with
    ``load_state_dict(strict=True)``)."""
    got = {k: tuple(getattr(v, "shape", ())) for k, v in state_dict.items()}
    want = expected_shapes(family)
    problems = [f"missing {k} {want[k]}" for k in sorted(set(want) - set(got))]
    problems += [f"extra   {k} {got[k]}" for k in sorted(set(got) - set(want))]
    problems += [f"shape   {k}: ckpt {got[k]} != model {want[k]}"
                 for k in sorted(set(got) & set(want)) if got[k] != want[k]]
    return problems


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--family", required=True, choices=FAMILIES)
    p.add_argument("--input", required=True,
                   help=".pt/.pth/.safetensors torch checkpoint")
    p.add_argument("--verify", action="store_true",
                   help="check the checkpoint against the full-size port "
                        "module's state_dict (the CLI's only mode: the port "
                        "loads torch checkpoints as they are)")
    args = p.parse_args(argv)
    if not args.verify:
        p.error("the port loads the reference's torch checkpoints as they "
                "are, so nothing is converted: pass --verify")
    from .pipeline import load_state_dict
    sd = unwrap(load_state_dict(args.input))
    problems = verify(args.family, sd)
    if problems:
        for line in problems[:40]:
            print(f"VERIFY FAIL: {line}")
        print(f"verify: {len(problems)} problems for {args.family}")
        return 1
    n = sum(v.numel() for v in sd.values())
    print(f"verify: {args.family} OK ({len(sd)} tensors, {n / 1e6:.1f}M "
          f"values match the full-size model)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
