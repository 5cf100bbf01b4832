"""Carry state across from the JAX package, as numpy arrays.

``gaussian_state_from_numpy`` takes the JAX ``GaussianState`` fields
(``np.asarray`` of each leaf) and builds the port's ``GaussianState`` on a
device; ``raster_camera_from_numpy`` does the same for a ``RasterCamera``
and ``train_state_from_numpy`` for a training ``TrainState`` (splats,
poses, exposure table, the three Adam states and the densify
statistics). PLY files need no converter: each package's ``load_ply``
reads the other's ``save_ply``.

``cogvideox_dit_from_numpy`` and ``cogvideox_vae_from_numpy`` turn the
JAX CogVideoX DiT's and VAE's flax params (numpy leaves) into the port's
state_dicts, which use diffusers' keys: they invert the JAX package's
``convert_cogvideox_dit`` and ``convert_cogvideox_vae``.
``dit_train_state_from_numpy`` carries a DiT fine-tune state across
(params, Adam moments and count, EMA, step) and ``lora_from_numpy`` a
LoRA adapter tree, so both packages can start a train step from one
state.
"""
from __future__ import annotations

import re

import numpy as np
import torch

from .ops.projection import RasterCamera
from .scene.gaussians import DensifyStats, GaussianState
from .train.field import TrainState
from .train.optim import AdamState
from .utils.device import resolve_device

GAUSSIAN_FIELDS = ("xyz", "knn_f", "features_dc", "features_rest", "scaling",
                   "rotation", "opacity", "language_feature",
                   "instance_feature", "alive")


def gaussian_state_from_numpy(d: dict,
                              device: torch.device | str | None = None
                              ) -> GaussianState:
    device = resolve_device(device)
    missing = [k for k in GAUSSIAN_FIELDS if k not in d]
    if missing:
        raise KeyError(f"missing GaussianState fields: {missing}")
    out = {}
    for k in GAUSSIAN_FIELDS:
        a = np.asarray(d[k])
        a = a.astype(bool) if k == "alive" else a.astype(np.float32)
        out[k] = torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return GaussianState(**out)


def raster_camera_from_numpy(w2c: np.ndarray, proj: np.ndarray, width: int,
                             height: int, tan_fovx: float, tan_fovy: float,
                             device: torch.device | str | None = None
                             ) -> RasterCamera:
    device = resolve_device(device)

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32).copy()).to(device)
    return RasterCamera(w2c=t(w2c), proj=t(proj), width=int(width),
                        height=int(height), tan_fovx=float(tan_fovx),
                        tan_fovy=float(tan_fovy))


def _f32(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32)).to(device)


def train_state_from_numpy(d: dict,
                           device: torch.device | str | None = None
                           ) -> TrainState:
    """Build a ``TrainState`` from numpy leaves::

        {"splats": {GaussianState fields}, "poses": [N,7], "app_ab": [N,2],
         "splat_opt": {"count": int, "mu": {group: arr}, "nu": {...}},
         "pose_opt": {"count": int, "mu": [N,7], "nu": [N,7]},
         "app_opt": {"count": int, "mu": [N,2], "nu": [N,2]},
         "stats": {DensifyStats fields}, "step": int}

    i.e. the optax ``ScaleByAdamState`` (count, mu, nu) of each optimizer,
    per group for the splat optimizer."""
    device = resolve_device(device)

    def adam(o, name=None):
        def leaves(x):
            if name is not None:
                return {name: _f32(x, device)}
            return {k: _f32(v, device) for k, v in x.items()}
        return AdamState(count=int(o["count"]), mu=leaves(o["mu"]),
                         nu=leaves(o["nu"]))
    return TrainState(
        splats=gaussian_state_from_numpy(d["splats"], device),
        poses=_f32(d["poses"], device), app_ab=_f32(d["app_ab"], device),
        splat_opt=adam(d["splat_opt"]),
        pose_opt=adam(d["pose_opt"], "poses"),
        app_opt=adam(d["app_opt"], "app_ab"),
        stats=DensifyStats(**{k: _f32(v, device)
                              for k, v in d["stats"].items()}),
        step=int(d["step"]))


def _linear(sd: dict, key: str, p: dict) -> None:
    """flax Dense {kernel [in, out], bias} -> torch Linear at ``key``."""
    sd[f"{key}.weight"] = np.asarray(p["kernel"]).T
    sd[f"{key}.bias"] = np.asarray(p["bias"])


def _norm(sd: dict, key: str, p: dict) -> None:
    """flax LayerNorm/GroupNorm {scale, bias} -> torch weight/bias."""
    sd[f"{key}.weight"] = np.asarray(p["scale"])
    sd[f"{key}.bias"] = np.asarray(p["bias"])


def _on(sd: dict, device) -> dict:
    dev = resolve_device(device)
    return {k: torch.from_numpy(np.array(v)).to(dev) for k, v in sd.items()}


def cogvideox_dit_from_numpy(flax_params: dict, head_dim: int = 64,
                             device: torch.device | str | None = None
                             ) -> dict:
    """JAX ``CogVideoXTransformer`` params (numpy leaves, with or without
    the top-level ``"params"``) -> the port's state_dict in diffusers'
    keys, on ``device``. The per-head-interleaved ``to_qkv`` of the fused
    JAX model splits into to_q/to_k/to_v (``head_dim`` must be the
    model's); ``proj_out`` rows go from the JAX (ph, pw, c) order to
    diffusers' (c, ph, pw)."""
    p = flax_params.get("params", flax_params)
    sd = {}
    k = np.asarray(p["patch_embed"]["kernel"])          # [p, p, C, hidden]
    sd["patch_embed.proj.weight"] = k.transpose(3, 2, 0, 1)
    sd["patch_embed.proj.bias"] = np.asarray(p["patch_embed"]["bias"])
    _linear(sd, "patch_embed.text_proj", p["text_proj"])
    _linear(sd, "time_embedding.linear_1", p["time_fc1"])
    _linear(sd, "time_embedding.linear_2", p["time_fc2"])
    i = 0
    while f"block_{i}" in p:
        blk, pre = p[f"block_{i}"], f"transformer_blocks.{i}"
        for n in ("norm1", "norm2"):
            _linear(sd, f"{pre}.{n}.linear", blk[n]["linear"])
            _norm(sd, f"{pre}.{n}.norm", blk[n]["norm"])
        attn = blk["attn"]
        if "to_qkv" in attn:
            w = np.asarray(attn["to_qkv"]["kernel"])     # [hidden, nh*3*hd]
            b = np.asarray(attn["to_qkv"]["bias"])
            if w.shape[1] % (3 * head_dim):
                raise ValueError(f"head_dim {head_dim} does not divide the "
                                 f"fused qkv width {w.shape[1]}")
            nh = w.shape[1] // (3 * head_dim)
            w = w.reshape(w.shape[0], nh, 3, head_dim)
            b = b.reshape(nh, 3, head_dim)
            for j, name in enumerate(("to_q", "to_k", "to_v")):
                _linear(sd, f"{pre}.attn1.{name}", {
                    "kernel": w[:, :, j].reshape(w.shape[0], -1),
                    "bias": b[:, j].reshape(-1)})
        else:
            for name in ("to_q", "to_k", "to_v"):
                _linear(sd, f"{pre}.attn1.{name}", attn[name])
        _linear(sd, f"{pre}.attn1.to_out.0", attn["to_out"])
        for n in ("norm_q", "norm_k"):
            _norm(sd, f"{pre}.attn1.{n}", attn[n])
        _linear(sd, f"{pre}.ff.net.0.proj", blk["ff"]["fc1"])
        _linear(sd, f"{pre}.ff.net.2", blk["ff"]["fc2"])
        i += 1
    _norm(sd, "norm_final", p["norm_final"])
    _linear(sd, "norm_out.linear", p["norm_out_linear"])
    _norm(sd, "norm_out.norm", p["norm_out"])
    ps = k.shape[0]
    w = np.asarray(p["proj_out"]["kernel"]).T            # rows (ph, pw, c)
    b = np.asarray(p["proj_out"]["bias"])
    c_out = w.shape[0] // (ps * ps)
    w = w.reshape(ps, ps, c_out, -1).transpose(2, 0, 1, 3).reshape(
        -1, w.shape[1])
    b = b.reshape(ps, ps, c_out).transpose(2, 0, 1).reshape(-1)
    sd["proj_out.weight"] = w
    sd["proj_out.bias"] = b
    return _on(sd, device)


_VAE_BLOCK = re.compile(r"^(down|up)_blocks_(\d+)_(resnets|downsamplers|"
                        r"upsamplers)_(\d+)$")
_VAE_MID = re.compile(r"^mid_resnets_(\d+)$")


def _vae_key(part: str) -> str:
    m = _VAE_BLOCK.match(part)
    if m:
        return f"{m[1]}_blocks.{m[2]}.{m[3]}.{m[4]}"
    m = _VAE_MID.match(part)
    return f"mid_block.resnets.{m[1]}" if m else part


def cogvideox_vae_from_numpy(flax_params: dict,
                             device: torch.device | str | None = None
                             ) -> dict:
    """JAX ``AutoencoderKL3D`` params (numpy leaves, with or without the
    top-level ``"params"``) -> the port's state_dict in diffusers' keys,
    on ``device``.
    3D kernels [kt,kh,kw,I,O] become Conv3d [O,I,kt,kh,kw]; the
    per-frame kernels of the down/upsamplers [1,kh,kw,I,O] become
    diffusers' Conv2d [O,I,kh,kw]; norm scales become weights."""
    p = flax_params.get("params", flax_params)
    sd = {}

    def walk(node, path):
        if not isinstance(node, dict):
            leaf = path[-1]
            key = ".".join(_vae_key(x) for x in path[:-1])
            a = np.asarray(node)
            if leaf == "kernel":
                if "samplers" in key:
                    a = a[0].transpose(3, 2, 0, 1)
                else:
                    a = a.transpose(4, 3, 0, 1, 2)
            name = "weight" if leaf in ("kernel", "scale") else leaf
            sd[f"{key}.{name}"] = a
            return
        for name, child in node.items():
            walk(child, path + (name,))

    walk(p, ())
    return _on(sd, device)


def dit_train_state_from_numpy(d: dict, head_dim: int = 64,
                               device: torch.device | str | None = None
                               ) -> dict:
    """A JAX DiT fine-tune state as numpy leaves::

        {"params": flax params, "opt": {"count": int, "mu": flax tree,
         "nu": flax tree}, "step": int, ["ema": flax params]}

    (``opt`` is the ``ScaleByAdamState`` of the optax chain) -> the state
    of ``train.dit.make_dit_train_step`` with tensors in diffusers' keys
    on ``device``. The moments and the EMA take the params' layout
    changes, which are permutations of their leaves."""
    def tree(t):
        return cogvideox_dit_from_numpy(t, head_dim=head_dim, device=device)
    out = {"params": tree(d["params"]),
           "opt": {"count": int(d["opt"]["count"]),
                   "mu": tree(d["opt"]["mu"]), "nu": tree(d["opt"]["nu"])},
           "step": int(d["step"])}
    if "ema" in d:
        out["ema"] = tree(d["ema"])
    return out


# JAX adapter path (after block_<i>/) -> the port's site (after
# transformer_blocks.<i>.)
_LORA_SITES = {"attn/to_qkv": "attn1.to_qkv", "attn/to_out": "attn1.to_out.0",
               "ff/fc1": "ff.net.0.proj", "ff/fc2": "ff.net.2"}


def lora_from_numpy(lora: dict, head_dim: int = 64,
                    device: torch.device | str | None = None) -> dict:
    """JAX LoRA adapters ``{"block_<i>/<path>": {"a": [in, r], "b": [r,
    out]}}`` (numpy) -> the port's ``{site: {"a", "b"}}`` f32 on
    ``device``. The fused q/k/v adapter keeps its shared A; its B
    [r, nh·3·hd], interleaved per head, is de-interleaved into the port's
    [q | k | v] columns, as ``cogvideox_dit_from_numpy`` splits the fused
    kernel."""
    dev = resolve_device(device)
    out = {}
    for path, ab in lora.items():
        blk, rest = path.split("/", 1)
        site = f"transformer_blocks.{int(blk[len('block_'):])}." \
               f"{_LORA_SITES[rest]}"
        a, b = np.asarray(ab["a"], np.float32), np.asarray(ab["b"],
                                                            np.float32)
        if rest == "attn/to_qkv":
            r = b.shape[0]
            b = b.reshape(r, -1, 3, head_dim).transpose(0, 2, 1, 3).reshape(
                r, -1)
        out[site] = {"a": _f32(a, dev), "b": _f32(b, dev)}
    return out
