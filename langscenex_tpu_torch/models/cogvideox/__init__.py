"""TriMap video diffusion: the CogVideoX keyframe-interpolation DiT, the 3D
causal VAE, the schedulers and the interpolation pipeline."""
