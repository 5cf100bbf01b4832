"""Plain reference of one VGGT forward in float32 PyTorch, from the weights
in facebook/VGGT-1B's state_dict keys: the DINOv2 ViT-L/14 with register
tokens, the aggregator's alternating frame and global blocks (per-head
qk-LayerNorm, 2D RoPE with the special tokens at position 0, LayerScale),
the camera head's adaLN refinement iterations over its trunk and the DPT
depth head (vggt/models/{vggt,aggregator}.py, vggt/layers/{block,
attention,rope,vision_transformer}.py, vggt/heads/{camera_head,dpt_head,
head_act,utils}.py).

TF32 is off while it runs. Attention is softmax(q kᵀ / sqrt(d)) v in
blocks of ``Q_BLOCK`` queries, so that the global attention over
67,326 tokens fits. ``precision="fp8"`` is the control: every matrix
product (the linears, the convolutions, attention's q, k and v) takes its
operands rounded to float8 e4m3 with one scale per tensor. It imports
nothing of the program.

Departures from upstream:

- the frames are taken at the configuration's ``img_size``, where the
  DINOv2 position table needs no resize (another grid raises);
- the point head, the track head and the camera head's per-iteration
  list are not computed: the pose encoding is the last iteration's;
- the DPT head runs ``FRAMES_CHUNK`` frames at a time, as upstream's
  does, and each frame's output is its own;
- the residual unit adds its input before the ReLU: x + conv(relu(conv(
  relu(x)))), the reading of dpt_head.py's ResidualConvUnit that the
  program and the JAX package share.
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

FP8_MAX = 448.0
Q_BLOCK = 1024                  # queries per block of the attention
FRAMES_CHUNK = 8                # frames per DPT-head pass
MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)


def fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under one scale for the tensor."""
    s = x.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
    return (x / s).to(torch.float8_e4m3fn).float() * s


@contextlib.contextmanager
def no_tf32():
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


class Ops:
    def __init__(self, precision: str, params: dict):
        if precision not in ("f32", "fp8"):
            raise ValueError(precision)
        self.q = fp8 if precision == "fp8" else (lambda x: x)
        self.p = params

    def w(self, name):
        return self.p[name].float()

    def linear(self, x, name):
        return F.linear(self.q(x), self.q(self.w(name + ".weight")),
                        self.w(name + ".bias"))

    def conv(self, x, name, bias=True, **kw):
        return F.conv2d(self.q(x), self.q(self.w(name + ".weight")),
                        self.w(name + ".bias") if bias else None, **kw)

    def conv_t(self, x, name, stride):
        return F.conv_transpose2d(self.q(x), self.q(self.w(name + ".weight")),
                                  self.w(name + ".bias"), stride=stride)

    def norm(self, x, name, eps):
        return F.layer_norm(x, x.shape[-1:], self.w(name + ".weight"),
                            self.w(name + ".bias"), eps)

    def attention(self, q, k, v):
        """q, k, v [B, H, N, d] -> [B, H, N, d]."""
        q, k, v = self.q(q), self.q(k), self.q(v)
        kt = k.transpose(-1, -2)
        scale = 1.0 / math.sqrt(q.shape[-1])
        out = torch.empty_like(q)
        for lo in range(0, q.shape[2], Q_BLOCK):
            s = torch.matmul(q[:, :, lo:lo + Q_BLOCK], kt) * scale
            out[:, :, lo:lo + Q_BLOCK] = torch.matmul(s.softmax(-1), v)
            del s
        return out


# ------------------------------------------------------------ 2D RoPE

def rope(x: torch.Tensor, pos: torch.Tensor, freq: float) -> torch.Tensor:
    """RotaryPositionEmbedding2D: x [B, H, N, d] at pos [N, 2] (y, x); the
    first half of d rotated by y, the second by x, each as
    x·cos + rotate_half(x)·sin with the angles repeated twice."""
    half = x.shape[-1] // 2
    inv = 1.0 / freq ** (torch.arange(0, half, 2, device=x.device).float()
                         / half)

    def one(t, p):
        ang = p[:, None] * inv
        ang = torch.cat([ang, ang], -1)
        t1, t2 = t[..., :half // 2], t[..., half // 2:]
        return t * ang.cos() + torch.cat([-t2, t1], -1) * ang.sin()
    return torch.cat([one(x[..., :half], pos[:, 0]),
                      one(x[..., half:], pos[:, 1])], -1)


# ------------------------------------------------------------ blocks

def block(op, b, x, heads, eps, pos=None, freq=None, qk_norm=False):
    """Pre-LN attention and MLP with LayerScale (vggt/layers/block.py)."""
    B, N, C = x.shape
    h = op.norm(x, b + "norm1", eps)
    qkv = op.linear(h, b + "attn.qkv").reshape(B, N, 3, heads, C // heads)
    q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)
    del qkv, h
    if qk_norm:
        q = op.norm(q, b + "attn.q_norm", 1e-5)
        k = op.norm(k, b + "attn.k_norm", 1e-5)
    if pos is not None:
        q, k = rope(q, pos, freq), rope(k, pos, freq)
    o = op.attention(q, k, v)
    del q, k, v
    o = op.linear(o.transpose(1, 2).reshape(B, N, C), b + "attn.proj")
    x = x + o * op.w(b + "ls1.gamma")
    h = op.linear(F.gelu(op.linear(op.norm(x, b + "norm2", eps),
                                   b + "mlp.fc1")), b + "mlp.fc2")
    return x + h * op.w(b + "ls2.gamma")


def vit(op, cfg, x):
    """DINOv2 ViT-L/14 with registers: x [N, 3, H, W] normalised -> the
    normalised patch tokens [N, P, C]."""
    pre = "aggregator.patch_embed."
    n = x.shape[0]
    grid = cfg["img_size"] // cfg["patch_size"]
    if x.shape[-2:] != (grid * cfg["patch_size"],) * 2:
        raise ValueError(f"frames {tuple(x.shape[-2:])}: the reference "
                         f"takes them at img_size {cfg['img_size']}")
    t = op.conv(x, pre + "patch_embed.proj", stride=cfg["patch_size"])
    t = t.flatten(2).transpose(1, 2)
    t = torch.cat([op.w(pre + "cls_token").expand(n, -1, -1), t], 1)
    t = t + op.w(pre + "pos_embed")
    t = torch.cat([t[:, :1], op.w(pre + "register_tokens").expand(n, -1, -1),
                   t[:, 1:]], 1)
    for i in range(cfg["vit_depth"]):
        t = block(op, f"{pre}blocks.{i}.", t, cfg["vit_num_heads"], 1e-6)
    return op.norm(t, pre + "norm", 1e-6)[:, 1 + cfg["num_register_tokens"]:]


def aggregator(op, cfg, images, until=None):
    """images [B, S, 3, H, W] in [0, 1] -> ({layer: [B, S, T, 2C]} for the
    layers the heads read, the blocks' input tokens [B, S, T, C], the
    number of special tokens); with ``until``, the tokens entering global
    block ``until`` [B, S·T, C] alone."""
    B, S, _, H, W = images.shape
    C = cfg["embed_dim"]
    mean = torch.tensor(MEAN, device=images.device).view(1, 1, 3, 1, 1)
    std = torch.tensor(STD, device=images.device).view(1, 1, 3, 1, 1)
    x = ((images - mean) / std).reshape(B * S, 3, H, W)
    patches = vit(op, cfg, x)
    ns = 1 + cfg["num_register_tokens"]

    def special(name):
        t = op.w("aggregator." + name)                     # [1, 2, n, C]
        return torch.cat([t[:, :1], t[:, 1:].expand(1, S - 1, -1, -1)], 1) \
            .expand(B, S, -1, -1).reshape(B * S, -1, C)
    tokens = torch.cat([special("camera_token"), special("register_token"),
                        patches], 1)
    T = tokens.shape[1]
    first = tokens.reshape(B, S, T, C)
    pos_g = grid_positions(cfg, S, images.device)
    pos = pos_g[:T]
    heads, freq = cfg["num_heads"], cfg["rope_freq"]
    needed = set(cfg["intermediate_layers"]) | {cfg["depth"] - 1}
    inters = {}
    for i in range(cfg["depth"]):
        tokens = block(op, f"aggregator.frame_blocks.{i}.", tokens, heads,
                       1e-5, pos, freq, qk_norm=True)
        frame_out = tokens
        if i == until:
            return tokens.reshape(B, S * T, C)
        tokens = block(op, f"aggregator.global_blocks.{i}.",
                       tokens.reshape(B, S * T, C), heads, 1e-5, pos_g, freq,
                       qk_norm=True).reshape(B * S, T, C)
        if i in needed:
            inters[i] = torch.cat([frame_out, tokens], -1).reshape(
                B, S, T, 2 * C)
    return inters, first, ns


# ------------------------------------------------------------ camera head

def camera_head(op, cfg, tokens):
    """The camera tokens [B, S, 2C] -> the last iteration's activated pose
    encoding [B, S, 9]: translation and quaternion linear, fov ReLU."""
    pre = "camera_head."
    B, S, C2 = tokens.shape
    pose_tokens = op.norm(tokens, pre + "token_norm", 1e-5)
    pred = None
    for _ in range(cfg["camera_iterations"]):
        inp = op.w(pre + "empty_pose_tokens").expand(B, S, 9) \
            if pred is None else pred
        inp = op.linear(inp, pre + "embed_pose")
        shift, scale, gate = op.linear(F.silu(inp),
                                       pre + "poseLN_modulation.1") \
            .chunk(3, -1)
        z = F.layer_norm(pose_tokens, (C2,), eps=1e-6) * (1 + scale) + shift
        z = gate * z + pose_tokens
        for i in range(cfg["camera_trunk_depth"]):
            z = block(op, f"{pre}trunk.{i}.", z, cfg["num_heads"], 1e-5)
        delta = op.linear(F.gelu(op.linear(
            op.norm(z, pre + "trunk_norm", 1e-5), pre + "pose_branch.fc1")),
            pre + "pose_branch.fc2")
        pred = delta if pred is None else pred + delta
    return torch.cat([pred[..., :7], F.relu(pred[..., 7:])], -1)


# ------------------------------------------------------------ DPT head

def uv_embed(h: int, w: int, dim: int, aspect: float, device):
    """create_uv_grid + position_grid_to_embed (omega_0 100, the
    frequencies in double as upstream builds them): [dim, h, w]."""
    diag = (aspect ** 2 + 1.0) ** 0.5
    sx, sy = aspect / diag, 1.0 / diag
    xs = torch.linspace(-sx * (w - 1) / w, sx * (w - 1) / w, w, device=device)
    ys = torch.linspace(-sy * (h - 1) / h, sy * (h - 1) / h, h, device=device)
    uu, vv = torch.meshgrid(xs, ys, indexing="xy")           # [h, w]

    def sincos(p, d):
        omega = torch.arange(d // 2, dtype=torch.float64,
                             device=device) / (d / 2.0)
        out = p.reshape(-1)[:, None].double() * (1.0 / 100.0 ** omega)
        return torch.cat([out.sin(), out.cos()], 1).float()
    emb = torch.cat([sincos(uu, dim // 2), sincos(vv, dim // 2)], -1)
    return emb.view(h, w, dim).permute(2, 0, 1)


def interp(x, size):
    return F.interpolate(x, size=size, mode="bilinear", align_corners=True)


def rcu(op, name, x):
    return op.conv(F.relu(op.conv(F.relu(x), name + ".conv1", padding=1)),
                   name + ".conv2", padding=1) + x


def fusion(op, name, x, res=None, size=None):
    if res is not None:
        x = x + rcu(op, name + ".resConfUnit1", res)
    x = rcu(op, name + ".resConfUnit2", x)
    size = size if size is not None else (x.shape[-2] * 2, x.shape[-1] * 2)
    return op.conv(interp(x, size), name + ".out_conv")


def dpt_frames(op, cfg, inters, hw):
    """One chunk of frames of the depth head: 4 tensors [n, P, 2C] -> depth
    [n, H, W], confidence [n, H, W]."""
    pre = "depth_head."
    H, W = hw
    p = cfg["patch_size"]
    hp, wp = H // p, W // p
    pyramid = []
    for i, t in enumerate(inters):
        x = op.norm(t, pre + "norm", 1e-5)
        x = x.permute(0, 2, 1).reshape(x.shape[0], -1, hp, wp)
        x = op.conv(x, f"{pre}projects.{i}")
        x = x + 0.1 * uv_embed(hp, wp, x.shape[1], W / H, x.device)
        if i == 0:
            x = op.conv_t(x, pre + "resize_layers.0", 4)
        elif i == 1:
            x = op.conv_t(x, pre + "resize_layers.1", 2)
        elif i == 3:
            x = op.conv(x, pre + "resize_layers.3", stride=2, padding=1)
        pyramid.append(x)
    sc = pre + "scratch."
    l1, l2, l3, l4 = (op.conv(x, f"{sc}layer{i + 1}_rn", bias=False,
                              padding=1) for i, x in enumerate(pyramid))
    out = fusion(op, sc + "refinenet4", l4, size=l3.shape[2:])
    out = fusion(op, sc + "refinenet3", out, l3, size=l2.shape[2:])
    out = fusion(op, sc + "refinenet2", out, l2, size=l1.shape[2:])
    out = fusion(op, sc + "refinenet1", out, l1)
    out = op.conv(out, sc + "output_conv1", padding=1)
    out = interp(out, (hp * p, wp * p))
    out = out + 0.1 * uv_embed(out.shape[-2], out.shape[-1], out.shape[1],
                               W / H, out.device)
    out = op.conv(F.relu(op.conv(out, sc + "output_conv2.0", padding=1)),
                  sc + "output_conv2.2")
    return torch.exp(out[:, 0]), 1.0 + torch.exp(out[:, 1])


def depth_head(op, cfg, inters, ns, hw):
    """[B, S, T, 2C] tensors of the intermediate layers -> depth and
    confidence [B, S, H, W]."""
    B, S = inters[0].shape[:2]
    depth, conf = [], []
    for s in range(0, S, FRAMES_CHUNK):
        chunk = [t[:, s:s + FRAMES_CHUNK, ns:].flatten(0, 1) for t in inters]
        d, c = dpt_frames(op, cfg, chunk, hw)
        depth.append(d.unflatten(0, (B, -1)))
        conf.append(c.unflatten(0, (B, -1)))
    return torch.cat(depth, 1), torch.cat(conf, 1)


def grid_positions(cfg: dict, frames: int, device) -> torch.Tensor:
    """A global block's RoPE positions [frames·T, 2]: each frame's special
    tokens at 0, its patch grid (y, x) + 1."""
    g = cfg["img_size"] // cfg["patch_size"]
    ys, xs = torch.meshgrid(torch.arange(g, device=device),
                            torch.arange(g, device=device), indexing="ij")
    pos = torch.cat([torch.zeros(1 + cfg["num_register_tokens"], 2,
                                 device=device),
                     torch.stack([ys.flatten(), xs.flatten()], -1) + 1.0])
    return pos.float().repeat(frames, 1)


@torch.no_grad()
def global_input(params: dict, cfg: dict, i: int,
                 images: torch.Tensor) -> torch.Tensor:
    """The tokens that the f32 forward of images [B, S, 3, H, W] brings to
    global block ``i``, [B, S·T, C]."""
    with no_tf32():
        return aggregator(Ops("f32", params), cfg, images.float(), until=i)


@torch.no_grad()
def global_block(params: dict, cfg: dict, i: int, x: torch.Tensor,
                 precision: str = "f32") -> torch.Tensor:
    """Global block ``i`` alone on its input x [B, S·T, C]."""
    with no_tf32():
        return block(Ops(precision, params), f"aggregator.global_blocks.{i}.",
                     x.float(), cfg["num_heads"], 1e-5,
                     grid_positions(cfg, cfg["num_frames"], x.device),
                     cfg["rope_freq"], qk_norm=True)


@torch.no_grad()
def forward(params: dict, cfg: dict, images: torch.Tensor,
            precision: str = "f32") -> dict:
    """images [B, S, 3, H, W] in [0, 1] -> {pose_enc [B, S, 9], depth,
    depth_conf [B, S, H, W], tokens: the last layer's [B, S, T, 2C],
    tokens_in: the blocks' input [B, S, T, C]}, in f32."""
    op = Ops(precision, params)
    with no_tf32():
        inters, first, ns = aggregator(op, cfg, images.float())
        last = inters[cfg["depth"] - 1]
        pose = camera_head(op, cfg, last[:, :, 0])
        depth, conf = depth_head(op, cfg, [inters[i] for i in
                                           cfg["intermediate_layers"]],
                                 ns, tuple(images.shape[-2:]))
    return dict(pose_enc=pose, depth=depth, depth_conf=conf, tokens=last,
                tokens_in=first)
