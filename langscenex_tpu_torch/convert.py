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
state. The ``*_from_numpy`` of LPIPS, T5, SAM1, SAM2, VGGT, CLIP's two
towers, the scene autoencoder (its batch statistics too) and the VQ
model invert the JAX package's ``convert_*``: each returns the
state_dict, in the reference checkpoint's keys, whose conversion gave
those params.
"""
from __future__ import annotations

import re

import numpy as np
import torch

from .ops.projection import RasterCamera
from .parallel.mesh import (lora_split_dim, shard_lora_tensor, shard_tensor,
                            tp_split_dim)
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


def shard_dit_state_dict(sd: dict, rank: int, n_model: int) -> dict:
    """Model rank ``rank``'s shard of a full DiT state_dict (diffusers'
    keys, as ``cogvideox_dit_from_numpy`` or a seeded model gives it):
    its heads of to_q/to_k/to_v, its rows of ff.net.0.proj, its input
    columns of attn1.to_out.0 and ff.net.2; everything else whole. The
    shards are views of ``sd``'s tensors."""
    return {k: shard_tensor(v, tp_split_dim(k), rank, n_model)
            for k, v in sd.items()}


def gather_dit_state_dict(shards: list) -> dict:
    """The full state_dict from every model rank's shard, in rank order
    (the inverse of :func:`shard_dit_state_dict`)."""
    out = {}
    for k, v in shards[0].items():
        dim = tp_split_dim(k)
        out[k] = v if dim is None or len(shards) == 1 else torch.cat(
            [s[k] for s in shards], dim=dim)
    return out


def shard_lora(lora: dict, rank: int, n_model: int) -> dict:
    """Model rank ``rank``'s shard of a full adapter tree ``{site: {"a",
    "b"}}``: B's columns of the column-parallel sites (for the fused q/k/v
    adapter the rank's heads of each of q, k and v), A's rows of the
    row-parallel ones; the other factor whole."""
    return {site: {k: shard_lora_tensor(site, k, t, rank, n_model)
                   for k, t in ab.items()} for site, ab in lora.items()}


def gather_lora(shards: list) -> dict:
    """The full adapter tree from every model rank's shard, in rank order
    (the inverse of :func:`shard_lora`)."""
    out = {}
    for site, ab in shards[0].items():
        out[site] = {}
        for k, t in ab.items():
            dim = lora_split_dim(site, k)
            parts = [s[site][k] for s in shards]
            if dim is None or len(shards) == 1:
                out[site][k] = t
            elif site.endswith(".attn1.to_qkv"):
                r = t.shape[0]
                out[site][k] = torch.cat([p.reshape(r, 3, -1) for p in parts],
                                         dim=2).reshape(r, -1)
            else:
                out[site][k] = torch.cat(parts, dim=dim)
    return out


def _params(tree: dict) -> dict:
    return tree.get("params", tree)


def _kernel(a: np.ndarray) -> np.ndarray:
    """A flax Dense or Conv kernel in torch's layout."""
    a = np.asarray(a)
    if a.ndim == 2:
        return a.T
    if a.ndim == 4:
        return a.transpose(3, 2, 0, 1)
    if a.ndim == 5:
        return a.transpose(4, 3, 0, 1, 2)
    raise ValueError(f"kernel rank {a.ndim}")


def discriminator_from_numpy(flax_params: dict,
                             device: torch.device | str | None = None
                             ) -> dict:
    """JAX ``Discriminator3D`` params -> the port's state_dict
    (``conv_{0,1,2}``, ``head``) on ``device``."""
    p = _params(flax_params)
    sd = {}
    for name, layer in p.items():
        sd[f"{name}.weight"] = _kernel(layer["kernel"])
        sd[f"{name}.bias"] = np.asarray(layer["bias"])
    return _on(sd, device)


def vae_train_state_from_numpy(d: dict,
                               device: torch.device | str | None = None):
    """A JAX ``VAETrainState`` as numpy leaves::

        {"vae_params": flax params, "disc_params": flax params,
         "vae_opt": {"count", "mu", "nu"}, "disc_opt": {...},
         "logvar": scalar, "lecam": {"real", "fake"}, "step": int}

    (each ``*_opt`` the ``ScaleByAdamState`` of its optax Adam) -> the
    port's ``train.vae.VAETrainState`` on ``device``; the moments take
    their parameters' layouts."""
    from .models.cogvideox.losses import LeCamEMA
    from .train.vae import VAETrainState

    def adam(o, conv):
        return AdamState(count=int(o["count"]), mu=conv(o["mu"], device),
                         nu=conv(o["nu"], device))
    dev = resolve_device(device)
    return VAETrainState(
        vae_params=cogvideox_vae_from_numpy(d["vae_params"], device),
        disc_params=discriminator_from_numpy(d["disc_params"], device),
        vae_opt=adam(d["vae_opt"], cogvideox_vae_from_numpy),
        disc_opt=adam(d["disc_opt"], discriminator_from_numpy),
        logvar=_f32(d["logvar"], dev),
        lecam=LeCamEMA(_f32(d["lecam"]["real"], dev),
                       _f32(d["lecam"]["fake"], dev)),
        step=int(d["step"]))


def lpips_from_numpy(flax_params: dict,
                     device: torch.device | str | None = None) -> dict:
    """JAX ``LPIPS`` params (``vgg/conv_i``, ``lin_i``) -> the port's
    state_dict in taming's keys (``net.slice*``, ``lin*.model.1``,
    ``scaling_layer``), inverting the JAX package's
    ``convert_lpips_vgg``."""
    from .models.lpips import SCALE, SHIFT, SLICES
    p = _params(flax_params)
    conv_idx = [i for a, b in SLICES for i in range(a, b)
                if i in (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)]
    slice_of = {i: s + 1 for s, (a, b) in enumerate(SLICES)
                for i in range(a, b)}
    sd = {"scaling_layer.shift": np.array(SHIFT, np.float32)[None, :, None,
                                                            None],
          "scaling_layer.scale": np.array(SCALE, np.float32)[None, :, None,
                                                            None]}
    for j, ti in enumerate(conv_idx):
        c = p["vgg"][f"conv_{j}"]
        key = f"net.slice{slice_of[ti]}.{ti}"
        sd[f"{key}.weight"] = _kernel(c["kernel"])
        sd[f"{key}.bias"] = np.asarray(c["bias"])
    for i in range(5):
        sd[f"lin{i}.model.1.weight"] = _kernel(p[f"lin_{i}"]["kernel"])
    return _on(sd, device)


def t5_encoder_from_numpy(flax_params: dict,
                          device: torch.device | str | None = None) -> dict:
    """JAX ``T5Encoder`` params -> the port's state_dict in Hugging Face
    ``T5EncoderModel``'s keys (the tied embedding under both names),
    inverting the JAX package's ``convert_t5_encoder``."""
    p = _params(flax_params)
    emb = np.asarray(p["token_embed"])
    sd = {"shared.weight": emb, "encoder.embed_tokens.weight": emb,
          "encoder.final_layer_norm.weight": np.asarray(
              p["ln_final"]["weight"])}
    i = 0
    while f"block_{i}" in p:
        blk, pre = p[f"block_{i}"], f"encoder.block.{i}.layer"
        for proj in ("q", "k", "v", "o"):
            sd[f"{pre}.0.SelfAttention.{proj}.weight"] = _kernel(
                blk["attn"][proj]["kernel"])
        if "relative_attention_bias" in blk["attn"]:
            sd[f"{pre}.0.SelfAttention.relative_attention_bias.weight"] = \
                np.asarray(blk["attn"]["relative_attention_bias"])
        sd[f"{pre}.0.layer_norm.weight"] = np.asarray(
            blk["ln_attn"]["weight"])
        for n in ("wi_0", "wi_1", "wo"):
            sd[f"{pre}.1.DenseReluDense.{n}.weight"] = _kernel(
                blk[n]["kernel"])
        sd[f"{pre}.1.layer_norm.weight"] = np.asarray(blk["ln_ff"]["weight"])
        i += 1
    return _on(sd, device)


# flax module names of the JAX SAM models -> the checkpoints' torch keys
_SAM_RENAMES = (
    (re.compile(r"^convs_(\d+)$"), r"convs.\1.conv"),
    (re.compile(r"^fuser_layers_(\d+)$"), r"fuser.layers.\1"),
    (re.compile(r"^obj_ptr_proj_(\d+)$"), r"obj_ptr_proj.layers.\1"),
    (re.compile(r"^mlp_fc(\d)$"), lambda m: f"mlp.layers.{int(m[1]) - 1}"),
    (re.compile(r"^mlp_(lin\d)$"), r"mlp.\1"),
    (re.compile(r"^(\w+?)_(\d+)$"), r"\1.\2"),
)
_SAM_NAMES = {"patch_embed_proj": "patch_embed.proj",
              "pe_gaussian": "pe_layer.positional_encoding_gaussian_matrix"}
_SAM_TOKENS = ("iou_token", "mask_tokens", "obj_score_token",
               "not_a_point_embed", "no_mask_embed", "point_embeddings")


def _sam_name(part: str) -> str:
    if part in _SAM_NAMES:
        return _SAM_NAMES[part]
    for pat, rep in _SAM_RENAMES:
        if pat.match(part):
            return pat.sub(rep, part)
    return part


def _sam_state_dict(p: dict, mlp_names=("layers.0", "layers.1")) -> dict:
    sd = {}

    def walk(node, path):
        if isinstance(node, dict):
            for name, child in node.items():
                walk(child, path + (name,))
            return
        parts = [_sam_name(x) for x in path]
        leaf, a = path[-1], np.asarray(node)
        if len(path) >= 2 and path[-2].startswith("mlp_layers_"):
            parts[-2] = "mlp." + mlp_names[int(path[-2][-1])]
        if leaf == "kernel":
            parts[-1], a = "weight", _kernel(a)
        elif leaf == "scale":
            parts[-1] = "weight"
        elif re.sub(r"_\d+$", "", leaf) in _SAM_TOKENS:
            parts.append("weight")
        elif leaf in ("pos_embed", "pos_embed_window") and a.ndim == 4 \
                and "trunk" in path:
            a = a.transpose(0, 3, 1, 2)
        sd[".".join(parts)] = a

    walk(p, ())
    return sd


def sam2_from_numpy(flax_params: dict,
                    device: torch.device | str | None = None) -> dict:
    """JAX ``SAM2`` params -> the port's state_dict in the
    sam2_hiera_large.pt keys, inverting the JAX package's
    ``convert_sam2``."""
    p = dict(_params(flax_params))
    sd = _sam_state_dict({k: v for k, v in p.items()
                          if k not in ("conv_s0", "conv_s1")})
    for k in ("conv_s0", "conv_s1"):
        sd[f"sam_mask_decoder.{k}.weight"] = _kernel(p[k]["kernel"])
        sd[f"sam_mask_decoder.{k}.bias"] = np.asarray(p[k]["bias"])
    return _on(sd, device)


def sam1_from_numpy(flax_params: dict,
                    device: torch.device | str | None = None) -> dict:
    """JAX ``SAM1`` params -> the port's state_dict in the
    sam_vit_h_4b8939.pth keys, inverting the JAX package's
    ``convert_sam1``. The JAX model has no mask prompt path, so the
    prompt encoder's ``mask_downscaling`` keys are absent: load with
    ``strict=False`` (they are unused)."""
    return _on(_sam_state_dict(_params(flax_params), ("lin1", "lin2")),
               device)


# flax module names of the JAX VGGT -> facebook/VGGT-1B's torch keys
_VGGT_NAMES = {"patch_embed_proj": "patch_embed.proj",
               "poseLN_modulation": "poseLN_modulation.1"}
_VGGT_RENAMES = (
    (re.compile(r"^(mlp|pose_branch)_(fc\d)$"), r"\1.\2"),
    (re.compile(r"^(\w+?)_(\d+)$"), r"\1.\2"),
)
_DPT_SCRATCH = re.compile(r"^(layer\d_rn|refinenet\d|output_conv\d(_\d)?)$")


def _vggt_name(part: str, in_dpt: bool) -> str:
    if part in _VGGT_NAMES:
        return _VGGT_NAMES[part]
    name = part
    for pat, rep in _VGGT_RENAMES:
        if pat.match(part):
            name = pat.sub(rep, part)
            break
    if in_dpt and _DPT_SCRATCH.match(part):
        name = "scratch." + name
    return name


def vggt_from_numpy(flax_params: dict,
                    device: torch.device | str | None = None) -> dict:
    """JAX ``VGGT`` params -> the port's state_dict in facebook/VGGT-1B's
    keys (``tests/torch_vggt_mirror.py``), inverting the JAX package's
    ``convert_vggt`` (with ``include_track`` when the tree has a track
    head). That converter drops DINOv2's unused ``mask_token``; it comes
    back as zeros."""
    dpt = {"depth_head", "point_head", "feature_extractor"}
    sd = _tree_state_dict(_params(flax_params), lambda name, path: _vggt_name(
        name, not dpt.isdisjoint(path)))
    cls = sd.get("aggregator.patch_embed.cls_token")
    if cls is not None:
        sd["aggregator.patch_embed.mask_token"] = np.zeros(
            (1, cls.shape[-1]), cls.dtype)
    return _on(sd, device)


def _tree_state_dict(p: dict, name_of) -> dict:
    """Flatten a flax tree into torch keys: ``name_of(name, ancestors)``
    maps each module name (``ancestors``: the flax names above it),
    ``kernel`` becomes a transposed ``weight``, ``scale`` a ``weight``."""
    sd = {}

    def walk(node, path, flax_path):
        if isinstance(node, dict):
            for name, child in node.items():
                walk(child, path + (name_of(name, flax_path),),
                     flax_path + (name,))
            return
        a = np.asarray(node)
        parts = list(path)
        if parts[-1] == "kernel":
            parts[-1], a = "weight", _kernel(a)
        elif parts[-1] == "scale":
            parts[-1] = "weight"
        sd[".".join(parts)] = a

    walk(p, (), ())
    return sd


def _clip_layers(p: dict) -> dict:
    layers = {k: v for k, v in p.items() if k.startswith("layers_")}

    def name(n, _):
        if n.startswith("layers_"):
            return "encoder.layers." + n[len("layers_"):]
        return "mlp." + n if n in ("fc1", "fc2") else n
    return _tree_state_dict(layers, name)


def clip_vision_from_numpy(flax_params: dict,
                           device: torch.device | str | None = None
                           ) -> dict:
    """JAX ``CLIPVisionDense`` params -> the port's state_dict in HF
    ``CLIPVisionModelWithProjection``'s keys, inverting the JAX package's
    ``convert_clip_vision``."""
    p = _params(flax_params)
    pre = "vision_model."
    sd = {pre + k: v for k, v in _clip_layers(p).items()}
    sd[pre + "embeddings.class_embedding"] = np.asarray(p["class_embedding"])
    sd[pre + "embeddings.position_embedding.weight"] = np.asarray(
        p["position_embedding"])
    sd[pre + "embeddings.patch_embedding.weight"] = _kernel(
        p["patch_embedding"]["kernel"])
    for ours, theirs in (("pre_layernorm", "pre_layrnorm"),
                         ("post_layernorm", "post_layernorm")):
        sd[pre + theirs + ".weight"] = np.asarray(p[ours]["scale"])
        sd[pre + theirs + ".bias"] = np.asarray(p[ours]["bias"])
    sd["visual_projection.weight"] = _kernel(
        p["visual_projection"]["kernel"])
    return _on(sd, device)


def clip_text_from_numpy(flax_params: dict,
                         device: torch.device | str | None = None) -> dict:
    """JAX ``CLIPTextEncoder`` params -> the port's state_dict in HF
    ``CLIPTextModelWithProjection``'s keys, inverting the JAX package's
    ``convert_clip_text``."""
    p = _params(flax_params)
    pre = "text_model."
    sd = {pre + k: v for k, v in _clip_layers(p).items()}
    sd[pre + "embeddings.token_embedding.weight"] = np.asarray(
        p["token_embedding"]["embedding"])
    sd[pre + "embeddings.position_embedding.weight"] = np.asarray(
        p["position_embedding"])
    sd[pre + "final_layer_norm.weight"] = np.asarray(
        p["final_layer_norm"]["scale"])
    sd[pre + "final_layer_norm.bias"] = np.asarray(
        p["final_layer_norm"]["bias"])
    sd["text_projection.weight"] = _kernel(p["text_projection"]["kernel"])
    return _on(sd, device)


def autoencoder_from_numpy(variables: dict,
                           device: torch.device | str | None = None
                           ) -> dict:
    """JAX ``Autoencoder`` variables ({"params", "batch_stats"}) -> the
    port's state_dict in the reference's keys (``encoder.{0,3,...}``
    Linear, ``encoder.{1,4,...}`` BatchNorm1d with its running statistics,
    ``decoder.{0,2,...}`` Linear), inverting the JAX package's
    ``convert_autoencoder``. ``num_batches_tracked``, which flax does not
    keep, is 0."""
    p, stats = variables["params"], variables["batch_stats"]
    sd = {}
    for j in range(len(p["encoder"]) - len(stats["encoder"])):
        d = p["encoder"][f"Dense_{j}"]
        mi = 3 * j
        sd[f"encoder.{mi}.weight"] = _kernel(d["kernel"])
        sd[f"encoder.{mi}.bias"] = np.asarray(d["bias"])
    for j in range(len(stats["encoder"])):
        bn, st, mi = (p["encoder"][f"BatchNorm_{j}"],
                      stats["encoder"][f"BatchNorm_{j}"], 3 * j + 1)
        sd[f"encoder.{mi}.weight"] = np.asarray(bn["scale"])
        sd[f"encoder.{mi}.bias"] = np.asarray(bn["bias"])
        sd[f"encoder.{mi}.running_mean"] = np.asarray(st["mean"])
        sd[f"encoder.{mi}.running_var"] = np.asarray(st["var"])
        sd[f"encoder.{mi}.num_batches_tracked"] = np.array(0, np.int64)
    for j in range(len(p["decoder"])):
        d = p["decoder"][f"Dense_{j}"]
        sd[f"decoder.{2 * j}.weight"] = _kernel(d["kernel"])
        sd[f"decoder.{2 * j}.bias"] = np.asarray(d["bias"])
    return _on(sd, device)


_VQ_RENAMES = (
    (re.compile(r"^down_(\d+)_res_(\d+)$"), r"down_blocks.\1.resnets.\2"),
    (re.compile(r"^down_(\d+)_downsample$"), r"down_blocks.\1.downsamplers.0"),
    (re.compile(r"^up_(\d+)_res_(\d+)$"), r"up_blocks.\1.resnets.\2"),
    (re.compile(r"^up_(\d+)_upsample$"), r"up_blocks.\1.upsamplers.0"),
    (re.compile(r"^mid_res_(\d+)$"), r"mid_block.resnets.\1"),
    (re.compile(r"^mid_attn$"), "mid_block.attentions.0"),
    (re.compile(r"^to_out$"), "to_out.0"),
)


def _vq_name(part: str, _=()) -> str:
    for pat, rep in _VQ_RENAMES:
        if pat.match(part):
            return pat.sub(rep, part)
    return part


def vq_model_from_numpy(flax_params: dict,
                        device: torch.device | str | None = None) -> dict:
    """JAX ``VQModel`` params -> the port's state_dict in diffusers'
    ``VQModel`` keys, inverting the JAX package's ``convert_vq_model``."""
    p = dict(_params(flax_params))
    codebook = p.pop("codebook")
    sd = _tree_state_dict(p, _vq_name)
    sd["quantize.embedding.weight"] = np.asarray(codebook)
    return _on(sd, device)
