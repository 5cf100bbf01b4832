"""Plain reference of the field trainer's semantic-phase step, in float32
PyTorch: the splats' projection, tile binning in depth order,
front-to-back compositing of the language channels, the phase's losses
(masked L1 on the language map, the semantic grouping loss, the 3D kNN
regulariser) and their gradient, and the Adam step on the language
features, the one group the phase trains.

Written from the published algorithm (the 3DGS rasterizer forward.cu
preprocess and blend, the reference trainer's losses and optax's Adam);
it imports nothing of the program. ``precision="tf32"`` is the control:
every matrix product and channel accumulation takes its operands rounded
to TF32's 10-bit mantissa.
"""
from __future__ import annotations

import math

import numpy as np
import torch

ALPHA_MAX = 0.99
ALPHA_MIN = 1.0 / 255.0
T_EPS = 1e-4
NEAR_Z = 0.2
DILATE = 0.3


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to the nearest TF32 value (10 explicit mantissa bits)."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


class Precision:
    def __init__(self, name: str):
        if name not in ("f32", "tf32"):
            raise ValueError(name)
        self.tf32 = name == "tf32"

    def r(self, x: torch.Tensor) -> torch.Tensor:
        return to_tf32(x) if self.tf32 else x

    def mm(self, a, b):
        return self.r(a) @ self.r(b)

    def bmm(self, a, b):
        return torch.bmm(self.r(a), self.r(b))


def projection_matrix(znear, zfar, fovx, fovy) -> np.ndarray:
    """OpenGL perspective, as the reference's graphics_utils builds it."""
    ty, tx = math.tan(fovy / 2), math.tan(fovx / 2)
    top, right = ty * znear, tx * znear
    P = np.zeros((4, 4), dtype=np.float32)
    P[0, 0] = 2.0 * znear / (2 * right)
    P[1, 1] = 2.0 * znear / (2 * top)
    P[3, 2] = 1.0
    P[2, 2] = zfar / (zfar - znear)
    P[2, 3] = -(zfar * znear) / (zfar - znear)
    return P


def _trunc_i(x, lo, hi):
    """float -> int truncation toward zero, clamped to [lo, hi]."""
    x = torch.nan_to_num(x, nan=0.0).clamp(lo - 1.0, hi + 1.0)
    return x.to(torch.int64).clamp(lo, hi)


def project(sp: dict, w2c: torch.Tensor, proj: torch.Tensor, W: int, H: int,
            tan_fx: float, tan_fy: float, tile: int):
    """Per splat: pixel mean, conic, opacity (0 where not drawn), view
    depth and tile rectangle [x0, x1) x [y0, y1)."""
    xyz = sp["xyz"]
    mx, my, mz = xyz[:, 0], xyz[:, 1], xyz[:, 2]
    s = torch.exp(sp["scaling"])
    q = sp["rotation"]
    q = q / torch.sqrt(torch.clamp((q * q).sum(-1, keepdim=True), min=1e-24))
    opac = torch.sigmoid(sp["opacity"][:, 0]) * sp["alive"]
    depth = w2c[2, 0] * mx + w2c[2, 1] * my + w2c[2, 2] * mz + w2c[2, 3]
    fp = proj @ w2c
    hx = fp[0, 0] * mx + fp[0, 1] * my + fp[0, 2] * mz + fp[0, 3]
    hy = fp[1, 0] * mx + fp[1, 1] * my + fp[1, 2] * mz + fp[1, 3]
    hw = fp[3, 0] * mx + fp[3, 1] * my + fp[3, 2] * mz + fp[3, 3]
    inv_w = 1.0 / torch.clamp(hw + 1e-7, min=1e-3)
    m2x = ((hx * inv_w + 1.0) * W - 1.0) * 0.5
    m2y = ((hy * inv_w + 1.0) * H - 1.0) * 0.5

    w, x, y, z = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    Rm = [[1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
          [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
          [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]]
    s2 = [s[:, 0] ** 2, s[:, 1] ** 2, s[:, 2] ** 2]

    def cov(i, j):
        return sum(s2[k] * Rm[i][k] * Rm[j][k] for k in range(3))
    S = [[cov(i, j) for j in range(3)] for i in range(3)]

    R = w2c[:3, :3]
    t = [R[i, 0] * mx + R[i, 1] * my + R[i, 2] * mz + w2c[i, 3]
         for i in range(3)]
    tz = torch.clamp(t[2], min=0.11)
    tx = torch.clamp(t[0] / tz, -1.3 * tan_fx, 1.3 * tan_fx) * tz
    ty = torch.clamp(t[1] / tz, -1.3 * tan_fy, 1.3 * tan_fy) * tz
    fx, fy = W / (2.0 * tan_fx), H / (2.0 * tan_fy)
    J = [[fx / tz, 0.0, -fx * tx / (tz * tz)],
         [0.0, fy / tz, -fy * ty / (tz * tz)]]
    M = [[J[r][0] * R[0, c] + J[r][2] * R[2, c] if r == 0 else
          J[r][1] * R[1, c] + J[r][2] * R[2, c] for c in range(3)]
         for r in range(2)]

    def proj2(r, c):
        return sum(M[r][i] * sum(S[i][j] * M[c][j] for j in range(3))
                   for i in range(3))
    a = proj2(0, 0) + DILATE
    b = proj2(0, 1)
    c = proj2(1, 1) + DILATE
    det = a * c - b * b
    ok = det > 0.0
    dinv = torch.where(ok, 1.0 / torch.where(ok, det, 1.0), 0.0)
    conic = torch.stack([c * dinv, -b * dinv, a * dinv], -1)
    mid = 0.5 * (a + c)
    lam = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    r3 = torch.where(ok, torch.ceil(3.0 * torch.sqrt(torch.clamp(lam, 0))),
                     0.0)
    qmax = torch.clamp(2.0 * torch.log(torch.clamp(255.0 * opac, min=1e-12))
                       + 0.05, max=9.0)
    rb = torch.where(ok, torch.ceil(torch.sqrt(torch.clamp(qmax, min=0.0)
                                               * torch.clamp(lam, min=0.0))),
                     0.0)
    gx, gy = -(-W // tile), -(-H // tile)
    x0 = _trunc_i((m2x - rb) / tile, 0, gx)
    y0 = _trunc_i((m2y - rb) / tile, 0, gy)
    x1 = torch.minimum(_trunc_i((m2x + r3 + tile - 1) / tile, 0, gx),
                       _trunc_i(torch.floor((m2x + rb) / tile), -1, gx - 1)
                       + 1)
    y1 = torch.minimum(_trunc_i((m2y + r3 + tile - 1) / tile, 0, gy),
                       _trunc_i(torch.floor((m2y + rb) / tile), -1, gy - 1)
                       + 1)
    n_tiles = (x1 - x0).clamp(min=0) * (y1 - y0).clamp(min=0)
    vis = (depth > NEAR_Z) & ok & (n_tiles > 0)
    return dict(mean2d=torch.stack([m2x, m2y], -1), conic=conic,
                opacity=torch.where(vis, opac, 0.0), depth=depth,
                rect=torch.stack([x0, y0, x1, y1], -1), visible=vis,
                grid=(gx, gy))


def tile_lists(pr: dict):
    """(starts, counts, splat ids) of every tile's pairs in (tile, depth)
    order, ties in splat order."""
    vis = torch.nonzero(pr["visible"]).reshape(-1)
    rect = pr["rect"][vis]
    nx = rect[:, 2] - rect[:, 0]
    ny = rect[:, 3] - rect[:, 1]
    cnt = nx * ny
    sid = torch.repeat_interleave(vis, cnt)
    first = torch.repeat_interleave(torch.cumsum(cnt, 0) - cnt, cnt)
    off = torch.arange(sid.shape[0], device=sid.device) - first
    nxp = torch.repeat_interleave(nx, cnt)
    gx, gy = pr["grid"]
    tile = ((torch.repeat_interleave(rect[:, 1], cnt) + off // nxp) * gx
            + torch.repeat_interleave(rect[:, 0], cnt) + off % nxp)
    order = torch.sort(pr["depth"][sid], stable=True).indices
    order = order[torch.sort(tile[order], stable=True).indices]
    counts = torch.bincount(tile, minlength=gx * gy)
    starts = torch.cumsum(counts, 0) - counts
    return starts, counts, sid[order]


def _pixels(gx, gy, tile, dev):
    t = torch.arange(gx * gy, device=dev)
    i = torch.arange(tile, device=dev)
    px = ((t % gx) * tile)[:, None, None] + i[None, None, :]
    py = ((t // gx) * tile)[:, None, None] + i[None, :, None]
    n = gx * gy
    return (px.expand(n, tile, tile).reshape(n, -1).float(),
            py.expand(n, tile, tile).reshape(n, -1).float())


def walk(pr: dict, lists, tile: int, chunk: int = 64):
    """Front to back over every tile's pairs: yields (ids [n_tiles, CH],
    in_range, weights [n_tiles, CH, npx]) per chunk of pairs."""
    starts, counts, ids_all = lists
    gx, gy = pr["grid"]
    dev = starts.device
    px, py = _pixels(gx, gy, tile, dev)
    T = torch.ones_like(px)
    done = torch.zeros(px.shape, dtype=torch.bool, device=dev)
    L = ids_all.shape[0]
    top = int(counts.max()) if counts.numel() else 0
    for c0 in range(0, top, chunk):
        k = c0 + torch.arange(chunk, device=dev)
        inr = k[None, :] < counts[:, None]
        ids = ids_all[torch.clamp(starts[:, None] + k[None, :], 0,
                                  max(L - 1, 0))]
        ids = torch.where(inr, ids, 0)
        xy, co, op = pr["mean2d"][ids], pr["conic"][ids], pr["opacity"][ids]
        dx = xy[..., 0:1] - px[:, None, :]
        dy = xy[..., 1:2] - py[:, None, :]
        power = (-0.5 * (co[..., 0:1] * dx * dx + co[..., 2:3] * dy * dy)
                 - co[..., 1:2] * dx * dy)
        alpha = torch.clamp(op[..., None] * torch.exp(power), max=ALPHA_MAX)
        gate = inr[..., None] & (power <= 0.0) & (alpha >= ALPHA_MIN)
        l1m = torch.where(gate, torch.log1p(-alpha), 0.0)
        cum = torch.cumsum(l1m, 1)
        T_in = T[:, None, :] * torch.exp(cum)
        inc = gate & (T_in >= T_EPS) & ~done[:, None, :]
        w = torch.where(inc, alpha * T[:, None, :] * torch.exp(cum - l1m),
                        0.0)
        T = T * torch.exp(torch.where(inc, l1m, 0.0).sum(1))
        done = done | (gate & (T_in < T_EPS)).any(1)
        yield ids, inr, w


def untile(x: torch.Tensor, gx: int, gy: int, tile: int, H: int, W: int):
    """[n_tiles, C, tile*tile] -> [C, H, W]."""
    C = x.shape[1]
    x = x.reshape(gy, gx, C, tile, tile).permute(2, 0, 3, 1, 4)
    return x.reshape(C, gy * tile, gx * tile)[:, :H, :W]


def tiled(img: torch.Tensor, gx: int, gy: int, tile: int) -> torch.Tensor:
    """[C, H, W] -> [n_tiles, C, tile*tile], zero past the image."""
    C, H, W = img.shape
    full = img.new_zeros((C, gy * tile, gx * tile))
    full[:, :H, :W] = img
    x = full.reshape(C, gy, tile, gx, tile).permute(1, 3, 0, 2, 4)
    return x.reshape(gy * gx, C, tile * tile)


def render_channels(pr, lists, feats, tile, H, W, pc: Precision):
    gx, gy = pr["grid"]
    acc = feats.new_zeros((gx * gy, feats.shape[1], tile * tile))
    for ids, inr, w in walk(pr, lists, tile):
        acc += pc.bmm(feats[ids].transpose(1, 2), w)
    return untile(acc, gx, gy, tile, H, W)


def channels_grad(pr, lists, g_img, n_splats, tile, pc: Precision):
    """d loss / d channels [P, C] from d loss / d image [C, H, W]."""
    gx, gy = pr["grid"]
    g = tiled(g_img, gx, gy, tile)
    out = g.new_zeros((n_splats + 1, g.shape[1]))
    for ids, inr, w in walk(pr, lists, tile):
        d = pc.bmm(w, g.transpose(1, 2))
        out.index_add_(0, torch.where(inr, ids, n_splats).reshape(-1),
                       d.reshape(-1, d.shape[-1]))
    return out[:n_splats]


def pairwise_l2(x, pc: Precision):
    sq = (x * x).sum(-1)
    d2 = sq[:, None] + sq[None, :] - 2.0 * pc.mm(x, x.T)
    return torch.sqrt(torch.clamp(d2, min=1e-12))


def group_loss(idx, seg, feat, pc: Precision):
    """Semantic grouping: mean L2 between sampled pixels of one segment
    over the upper triangle's pairs, doubled."""
    n = idx.shape[0]
    s, f = seg[idx], feat[idx]
    iu = torch.ones((n, n), dtype=torch.bool, device=f.device).triu(1)
    same = (s[:, None] == s[None, :]) & iu
    tot = torch.where(same, pairwise_l2(f, pc), 0.0).sum()
    return 2.0 * tot / (n * (n + 1) // 2)


def knn_smallest(d2, k):
    """The k smallest entries' columns of each row, ties to the lower
    column."""
    vals, idx = torch.topk(d2, k, dim=1, largest=False)
    amb = torch.nonzero((d2 <= vals[:, -1:]).sum(1) > k).reshape(-1)
    if amb.numel():
        idx = idx.clone()
        idx[amb] = torch.sort(d2[amb], dim=1, stable=True).indices[:, :k]
    return idx


def cls3d_loss(idx, xyz, pred, k, lam, pc: Precision):
    """3D kNN regulariser: KL of each sampled splat's min-max normalised
    prediction against its k nearest splats'."""
    lo, hi = pred.min(), pred.max()
    p = torch.where(hi > lo, (pred - lo) / (hi - lo + 1e-12), pred)
    sf, sp = xyz[idx], p[idx]
    d2 = (sf ** 2).sum(-1)[:, None] + (xyz ** 2).sum(-1)[None, :] \
        - 2.0 * pc.mm(sf, xyz.T)
    nb = p[knn_smallest(d2.detach(), k)]
    kl = sp[:, None] * (torch.log(sp[:, None] + 1e-10) - torch.log(nb + 1e-10))
    return lam * kl.abs().mean()


def adam(p, g, mu, nu, count, lr, b1=0.9, b2=0.999, eps=1e-15):
    """optax's Adam: moments, bias corrections at t = count + 1 in f32."""
    t = np.float32(count + 1)
    bc1 = float(np.float32(1) - np.float32(b1) ** t)
    bc2 = float(np.float32(1) - np.float32(b2) ** t)
    mu = (1 - b1) * g + b1 * mu
    nu = (1 - b2) * (g * g) + b2 * nu
    upd = (mu / bc1) / (torch.sqrt(nu / bc2) + eps)
    return p + float(-lr) * upd, mu, nu


def semantic_steps(sp: dict, views: list, opt: dict, cam: dict,
                   precision: str = "f32") -> dict:
    """Follow the trainer's semantic-phase steps from ``sp`` (the splats'
    raw parameters). ``views``: per step a dict of ``w2c`` [4, 4],
    ``lang`` [3, H, W], ``seg`` [H, W] int (-1 masked), ``group_idx`` and
    ``obj_idx``. ``cam``: width, height, fovx, fovy, tile. Returns each
    step's loss, the first step's gradient of the language features and
    the features after the last step."""
    pc = Precision(precision)
    W, H, tile = cam["width"], cam["height"], cam["tile"]
    dev = sp["xyz"].device
    tan_fx, tan_fy = math.tan(cam["fovx"] / 2), math.tan(cam["fovy"] / 2)
    proj = torch.as_tensor(projection_matrix(0.01, 100.0, cam["fovx"],
                                             cam["fovy"]), device=dev)
    lang = sp["language_feature"].clone()
    mu, nu = torch.zeros_like(lang), torch.zeros_like(lang)
    P = lang.shape[0]
    losses, grad1 = [], None
    for i, v in enumerate(views):
        pr = project(sp, v["w2c"], proj, W, H, tan_fx, tan_fy, tile)
        lists = tile_lists(pr)
        with torch.no_grad():
            img = render_channels(pr, lists, lang, tile, H, W, pc)
        img = img.detach().requires_grad_()
        feat = lang.detach().requires_grad_()
        m = (v["seg"] != -1)[None].float()
        l1 = (img * m - v["lang"] * m).abs().mean()
        gl = group_loss(v["group_idx"], v["seg"].reshape(-1),
                        img.reshape(3, -1).T, pc)
        cl = cls3d_loss(v["obj_idx"], sp["xyz"], feat, opt["reg3d_k"],
                        opt["reg3d_lambda_val"], pc)
        total = l1 + gl + cl
        g_img, g_feat = torch.autograd.grad(total, [img, feat])
        with torch.no_grad():
            g_render = channels_grad(pr, lists, g_img, P, tile, pc)
            g = g_feat + g_render
            lang, mu, nu = adam(lang, g, mu, nu, i,
                                opt["language_feature_lr"])
        losses.append(dict(lang=float(l1.detach()), group=float(gl.detach()),
                           knn=float(cl.detach())))
        if grad1 is None:
            grad1 = g
            # rows that only the render's losses reach
            render_rows = ((g_feat == 0).all(1)
                           & (g_render != 0).any(1))
    return dict(losses=losses, grad1=grad1, lang=lang,
                render_rows=render_rows)
