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
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F


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
    stable sort."""
    vals, idx = torch.topk(d2, k, dim=1, largest=False)
    ambiguous = (d2 <= vals[:, -1:]).sum(1) > k
    rows = torch.nonzero(ambiguous).reshape(-1)
    if rows.numel():
        idx = idx.clone()
        idx[rows] = torch.sort(d2[rows], dim=1, stable=True).indices[:, :k]
    return idx


def loss_cls_3d(idx: torch.Tensor, features: torch.Tensor,
                predictions: torch.Tensor, k: int = 5,
                lambda_val: float = 2.0) -> torch.Tensor:
    """kNN KL regularizer on per-splat predictions. ``idx`` [S] are the
    sampled splats (the JAX version's ``permutation(key, N)[:800]``),
    ``features`` [N,3] positions, ``predictions`` [N,C]."""
    pmin, pmax = predictions.min(), predictions.max()
    preds = torch.where(pmax > pmin,
                        (predictions - pmin) / (pmax - pmin + 1e-12),
                        predictions)
    sf = features[idx]
    sp = preds[idx]
    with exact_f32():
        d2 = ((sf ** 2).sum(-1)[:, None] + (features ** 2).sum(-1)[None, :]
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
