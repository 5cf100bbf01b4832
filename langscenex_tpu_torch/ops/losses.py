"""Training losses for field construction, port of the JAX
``ops/losses.py``.

Parity targets: field_construction/utils/loss_utils.py — l1 (:20-29), SSIM
(:44-75), image-gradient weight (:105-117), patchwise LNCC (:120-155),
kNN-KL 3D regularizer loss_cls_3d (:158-186), semantic grouping
(:189-214), instance contrastive grouping (:217-260), ranking loss
(:262-273).

Sampling: where the JAX losses draw with a PRNG key, these take the drawn
indices as a tensor (``idx``), so a test can inject JAX's own draws and
the trainer draws from a ``torch.Generator``.

Precision: every loss is exact f32 whatever the global flags say. SSIM's
Gaussian filter is an explicit f32 shifted-slice sum (no convolution, so
cuDNN's default TF32 never applies: E[x^2] - E[x]^2 cancels at reduced
precision), and the matrix products run inside :func:`exact_f32`.

The 3D kNN regulariser's neighbour search runs kernel K14
(:func:`knn_select`, ``csrc/knn_select.cu``) or the plain dense d2 with
:func:`_knn_smallest`, by ``_build``'s rule. On the card K14's distances
are the dense expression's bit for bit, so both select the same neighbours.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from .. import _build
from ..utils import profiling


@contextlib.contextmanager
def exact_f32():
    """Run float32 matrix products in full f32 (no TF32) inside the block
    and restore the caller's setting after it."""
    prev = torch.get_float32_matmul_precision()
    prev_cudnn = torch.backends.cudnn.allow_tf32
    torch.set_float32_matmul_precision("highest")
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)
        torch.backends.cudnn.allow_tf32 = prev_cudnn


def l1_loss(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return (x - y).abs().mean()


# ---------------------------------------------------------------- SSIM

def _gaussian_window(window_size: int, sigma: float,
                     device) -> torch.Tensor:
    xs = (torch.arange(window_size, dtype=torch.float32, device=device)
          - window_size // 2)
    g = torch.exp(-(xs ** 2) / (2.0 * sigma ** 2))
    return g / g.sum()


def _sep_filter2d(img: torch.Tensor, w1d: torch.Tensor) -> torch.Tensor:
    """Separable 2D filter with zero SAME padding on [C,H,W], as the
    cross-correlation of the JAX ``_sep_filter2d``, in plain f32."""
    k = w1d.shape[0]
    pad = k // 2
    H, W = img.shape[-2:]
    x = F.pad(img, (0, 0, pad, pad))
    x = sum(w1d[i] * x[:, i:i + H, :] for i in range(k))
    x = F.pad(x, (pad, pad))
    return sum(w1d[i] * x[:, :, i:i + W] for i in range(k))


def ssim(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11,
         sigma: float = 1.5) -> torch.Tensor:
    """Mean SSIM over [C,H,W] images: 11x11 Gaussian window (sigma 1.5),
    zero SAME padding, C1 = 0.01^2, C2 = 0.03^2."""
    w = _gaussian_window(window_size, sigma, img1.device)
    mu1, mu2 = _sep_filter2d(img1, w), _sep_filter2d(img2, w)
    mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    s1 = _sep_filter2d(img1 * img1, w) - mu1_sq
    s2 = _sep_filter2d(img2 * img2, w) - mu2_sq
    s12 = _sep_filter2d(img1 * img2, w) - mu12
    C1, C2 = 0.01 ** 2, 0.03 ** 2
    smap = (((2 * mu12 + C1) * (2 * s12 + C2))
            / ((mu1_sq + mu2_sq + C1) * (s1 + s2 + C2)))
    return smap.mean()


# ------------------------------------------------- image gradient weight

def image_grad_weight(img: torch.Tensor) -> torch.Tensor:
    """[C,H,W] -> [H,W] edge-awareness weight in [0,1], border 1."""
    gx = (img[:, 1:-1, 2:] - img[:, 1:-1, :-2]).abs().mean(0)
    gy = (img[:, :-2, 1:-1] - img[:, 2:, 1:-1]).abs().mean(0)
    g = torch.maximum(gx, gy)
    g = (g - g.min()) / (g.max() - g.min() + 1e-12)
    return F.pad(g, (1, 1, 1, 1), value=1.0)


# ----------------------------------------------------------------- LNCC

def lncc(ref: torch.Tensor, nea: torch.Tensor):
    """Patchwise normalized cross-correlation: ref, nea [B, patch*patch]
    -> (ncc [B,1] = clip(1 - cc, 0, 2), mask [B,1] = ncc < 0.9)."""
    tps = ref.shape[-1]
    ref_sum = ref.sum(-1)
    nea_sum = nea.sum(-1)
    ref2_sum = (ref * ref).sum(-1)
    nea2_sum = (nea * nea).sum(-1)
    ref_nea_sum = (ref * nea).sum(-1)
    ref_avg = ref_sum / tps
    nea_avg = nea_sum / tps
    cross = ref_nea_sum - nea_avg * ref_sum
    ref_var = ref2_sum - ref_avg * ref_sum
    nea_var = nea2_sum - nea_avg * nea_sum
    cc = cross * cross / (ref_var * nea_var + 1e-8)
    ncc = torch.clamp(1.0 - cc, 0.0, 2.0)[:, None]
    return ncc, ncc < 0.9


# ----------------------------------------------------- 3D kNN-KL smoothing

def _knn_smallest(d2: torch.Tensor, k: int) -> torch.Tensor:
    """Indices [S, k] of the k smallest entries of each row, ties to the
    lower index (the set ``lax.top_k(-d2, k)`` selects). ``topk`` gives no
    tie order, so rows where the k-th value is tied are re-ranked by a
    stable sort. Counts the rows (``knn.rows``) and the re-ranked ones
    (``knn.tie_rows``)."""
    vals, idx = torch.topk(d2, k, dim=1, largest=False)
    ambiguous = (d2 <= vals[:, -1:]).sum(1) > k
    rows = torch.nonzero(ambiguous).reshape(-1)
    profiling.count("knn.rows", d2.shape[0])
    profiling.count("knn.tie_rows", rows.numel())
    if rows.numel():
        idx = idx.clone()
        idx[rows] = torch.sort(d2[rows], dim=1, stable=True).indices[:, :k]
    return idx


KNN_MAX_K = 16      # K14's largest k: its k-lists live in registers


def _knn_check(what: str, sf, sq_s, features, sq_f) -> tuple:
    """(S, N) of K14's inputs: f32 contiguous sf [S, 3], sq_s [S],
    features [N, 3], sq_f [N] on one CUDA device; raises otherwise."""
    ts = (sf, sq_s, features, sq_f)
    if len({t.device for t in ts}) != 1:
        raise ValueError(f"{what}: inputs on {[str(t.device) for t in ts]}")
    if any(t.dtype != torch.float32 for t in ts):
        raise TypeError(f"{what} takes f32 tensors, got "
                        f"{[t.dtype for t in ts]}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError(f"{what} takes contiguous tensors")
    S, N = sf.shape[0], features.shape[0]
    if (sf.shape != (S, 3) or features.shape != (N, 3)
            or sq_s.shape != (S,) or sq_f.shape != (N,)):
        raise ValueError(f"{what} wants sf [S, 3], sq_s [S], features "
                         f"[N, 3], sq_f [N], got {[tuple(t.shape) for t in ts]}")
    if sf.device.type != "cuda":
        raise ValueError(f"{what}: kNN kernel K14 takes CUDA tensors, got "
                         f"{sf.device}")
    if N >= 2 ** 30 or S >= 2 ** 31:
        raise ValueError(f"{what}: kNN kernel K14 takes fewer than 2^30 "
                         f"slots and 2^31 rows")
    return S, N


def knn_select(sf: torch.Tensor, sq_s: torch.Tensor, features: torch.Tensor,
               sq_f: torch.Tensor, k: int):
    """Launch K14: for each row i of ``sf`` [S, 3] (norms ``sq_s`` [S]) the
    k slots j of ``features`` [N, 3] (norms ``sq_f`` [N]) with the smallest
    ``d2 = (sq_s[i] + sq_f[j]) - 2 sf[i] . features[j]``, ties to the lower
    slot, in ascending (d2, slot) order. Returns (d2 [S, k] f32, slots
    [S, k] int64); d2 is the dense expression's at "highest" precision bit
    for bit. Takes f32 contiguous tensors on one CUDA device and
    1 <= k <= min(16, N); raises on anything else and never falls back to
    the plain version. Counts the rows (``knn.rows``)."""
    if not 1 <= k <= KNN_MAX_K or k > features.shape[0]:
        raise ValueError(f"knn_select takes 1 <= k <= min({KNN_MAX_K}, N = "
                         f"{features.shape[0]}), got k = {k}")
    S, N = _knn_check("knn_select", sf, sq_s, features, sq_f)
    dev = sf.device
    vals = torch.empty((S, k), dtype=torch.float32, device=dev)
    cols = torch.empty((S, k), dtype=torch.int64, device=dev)
    profiling.count("knn.rows", S)
    if S == 0:
        return vals, cols
    scratch = torch.empty(_build.knn_select_scratch(S, N, k, dev.index),
                          dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        _build.launch("knn_select", dev, sf.data_ptr(), sq_s.data_ptr(),
                      features.data_ptr(), sq_f.data_ptr(), vals.data_ptr(),
                      cols.data_ptr(), scratch.data_ptr(), S, N, k)
    return vals, cols


def loss_cls_3d(idx: torch.Tensor, features: torch.Tensor,
                predictions: torch.Tensor, k: int = 5,
                lambda_val: float = 2.0) -> torch.Tensor:
    """kNN KL regularizer on per-splat predictions. ``idx`` [S] are the
    sampled splats (the JAX version's ``permutation(key, N)[:800]``),
    ``features`` [N,3] positions, ``predictions`` [N,C]. The neighbours:
    K14, or the dense d2 and :func:`_knn_smallest`, by ``_build``'s rule."""
    pmin, pmax = predictions.min(), predictions.max()
    preds = torch.where(pmax > pmin,
                        (predictions - pmin) / (pmax - pmin + 1e-12),
                        predictions)
    sf = features[idx]
    sp = preds[idx]
    if _build.use_kernel(features):
        with torch.no_grad():
            sfc, fc = sf.contiguous(), features.contiguous()
            nbr = knn_select(sfc, (sfc ** 2).sum(-1), fc,
                             (fc ** 2).sum(-1), k)[1]
    else:
        with exact_f32():
            d2 = ((sf ** 2).sum(-1)[:, None]
                  + (features ** 2).sum(-1)[None, :]
                  - 2.0 * (sf @ features.T))
        nbr = _knn_smallest(d2.detach(), k)
    nbr_preds = preds[nbr]                              # [S,k,C]
    kl = sp[:, None] * (torch.log(sp[:, None] + 1e-10)
                        - torch.log(nbr_preds + 1e-10))
    return lambda_val * kl.abs().mean()


# ------------------------------------------------------ grouping losses

def _pairwise_l2(x: torch.Tensor) -> torch.Tensor:
    """[N,C] -> [N,N] L2 distances via the matmul identity."""
    sq = (x * x).sum(-1)
    with exact_f32():
        d2 = sq[:, None] + sq[None, :] - 2.0 * (x @ x.T)
    return torch.sqrt(torch.clamp(d2, min=1e-12))


def _upper_masks(n: int, device):
    iu = torch.ones((n, n), dtype=torch.bool, device=device).triu()
    diag = torch.eye(n, dtype=torch.bool, device=device)
    return iu, diag


def loss_semantic_group(idx: torch.Tensor, gt_seg: torch.Tensor,
                        language_feature: torch.Tensor) -> torch.Tensor:
    """Pull together the language features of sampled pixels with the same
    seg id. ``idx`` [num] are the sampled pixels, gt_seg [N] int,
    language_feature [N,C]."""
    num = idx.shape[0]
    seg = gt_seg[idx]
    feat = language_feature[idx]
    iu, diag = _upper_masks(num, feat.device)
    pair_mask = (seg[:, None] == seg[None, :]) & iu & ~diag
    d = _pairwise_l2(feat)
    total = torch.where(pair_mask, d, 0.0).sum()
    return 2.0 * total / iu.sum()


def loss_instance_group(idx: torch.Tensor, sam_seg: torch.Tensor,
                        instance_feature: torch.Tensor,
                        language_feature: torch.Tensor,
                        margin: float = 1.0) -> torch.Tensor:
    """Contrastive instance grouping with language-similarity-weighted
    negatives, over the sampled pixels ``idx`` [num]."""
    num = idx.shape[0]
    seg = sam_seg[idx]
    inst = instance_feature[idx]
    lang = language_feature[idx]
    same = seg[:, None] == seg[None, :]
    iu, diag = _upper_masks(num, inst.device)
    pos_mask = same & iu & ~diag
    neg_mask = ~same & iu
    d = _pairwise_l2(inst)
    pos = torch.where(pos_mask, d, 0.0).sum()
    lnorm = lang / (torch.linalg.norm(lang, dim=-1, keepdim=True) + 1e-8)
    with exact_f32():
        cos_sim = lnorm @ lnorm.T
    neg = torch.where(neg_mask, torch.relu(margin - d) * (1.0 + cos_sim),
                      0.0).sum()
    return 2.0 * (pos + neg) / iu.sum()


def ranking_loss(error: torch.Tensor, penalize_ratio: float = 1.0,
                 kind: str = "mean") -> torch.Tensor:
    """Mean (or sum) of the largest ``penalize_ratio`` fraction of errors."""
    flat = torch.sort(error.reshape(-1), descending=True).values
    k = int(penalize_ratio * flat.shape[0])
    sel = flat[:k]          # k == 0: an empty sum, zero with zero gradient
    if k == 0:
        return sel.sum()
    return sel.mean() if kind == "mean" else sel.sum()
