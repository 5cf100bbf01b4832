"""The port's models: ``cogvideox`` (TriMap's DiT, 3D VAE, schedulers,
pipeline, datasets and VAE losses), ``t5``/``t5_encoder`` (prompt
embedding with the T5-XXL encoder or the hash stub), ``lpips``
(the VAE fine-tune's perceptual loss), ``sam1`` and ``sam2`` (auto-seg's
proposal and tracking models), ``vggt`` and ``vggt_track`` (pose
lifting), ``clip_dense``, ``openseg``, ``autoencoder``, ``lseg`` and
``vq_model`` (language lifting)."""
