"""Named configuration presets.

Port of the JAX ``langscenex_tpu/utils/presets.py`` (the reference's
configs/unet_config_c16.py / unet_config_c32.py / test_config.py and the
configs/field_construction.yaml defaults): the same ``PRESETS`` names,
each returning the port's ``VAEConfig``, ``TransformerConfig`` or
``GaussianConfig``.
"""
from __future__ import annotations

from ..models.cogvideox.transformer import TransformerConfig
from ..models.cogvideox.vae import VAEConfig
from .config import GaussianConfig


def vae_c16() -> VAEConfig:
    """16-latent-channel 3D VAE (unet_config_c16.py:20-26 scale)."""
    return VAEConfig(latent_channels=16)


def vae_c32() -> VAEConfig:
    """32-latent-channel variant (unet_config_c32.py)."""
    return VAEConfig(latent_channels=32)


def vae_test() -> VAEConfig:
    """Small config for smoke runs (test_config.py:17-25 analogue)."""
    return VAEConfig(block_out_channels=(32, 64, 64, 128),
                     layers_per_block=1, latent_channels=8, norm_groups=8)


def cogvideox_5b() -> TransformerConfig:
    """The reference fine-tune base (CogVideoX-5b-I2V scale)."""
    return TransformerConfig()


def cogvideox_2b() -> TransformerConfig:
    return TransformerConfig(num_layers=30, num_heads=30, head_dim=64,
                             use_rotary=False)


def field_construction_default() -> GaussianConfig:
    """configs/field_construction.yaml defaults."""
    return GaussianConfig()


PRESETS = {
    "vae_c16": vae_c16, "vae_c32": vae_c32, "vae_test": vae_test,
    "cogvideox_5b": cogvideox_5b, "cogvideox_2b": cogvideox_2b,
    "field_construction": field_construction_default,
}
