"""Step-function (piecewise-constant PDF) toolkit, mip-NeRF family.

Port of the JAX package's ``utils/stepfun.py`` (the reference's
``utils/stepfun.py``; its camera-path generators import ``sample``) on
torch tensors: every public function, batched over leading dims and
differentiable. A step function is (``t`` [..., n+1] sorted fenceposts,
``w``/``y`` [..., n] per-bin values); every function works on the last
axis.

Randomness is an explicit ``torch.Generator``: ``key=None`` is the
deterministic linspace path, otherwise :func:`sample` draws its jitter
from the generator passed as ``key`` (the JAX package takes a PRNG key
there). ``_EPS`` is float32's machine epsilon, as in JAX.
"""
from __future__ import annotations

import math

import torch

_EPS = float(torch.finfo(torch.float32).eps)


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``take_along_axis(x, idx, -1)`` with the leading dims of both
    broadcast against each other."""
    batch = torch.broadcast_shapes(x.shape[:-1], idx.shape[:-1])
    return torch.gather(x.expand(batch + x.shape[-1:]), -1,
                        idx.expand(batch + idx.shape[-1:]))


def searchsorted(a: torch.Tensor, v: torch.Tensor):
    """Bracketing indices of queries ``v`` in sorted fenceposts ``a``:
    ``(idx_lo, idx_hi)`` with ``a[idx_lo] <= v < a[idx_hi]``; out-of-range
    queries get both indices clamped to the first/last position."""
    n = a.shape[-1]
    i = torch.arange(n, device=a.device)[:, None]
    ge = v[..., None, :] >= a[..., :, None]          # [..., n, m]
    idx_lo = torch.where(ge, i, 0).amax(-2)
    idx_hi = torch.where(~ge, i, n - 1).amin(-2)
    return idx_lo, idx_hi


def sorted_interp(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor):
    """Batched linear interpolation of ``fp(xp)`` at ``x`` (xp sorted),
    ``np.interp`` per batch row (constant outside)."""
    idx_lo, idx_hi = searchsorted(xp, x)
    xp_lo, xp_hi = _take(xp, idx_lo), _take(xp, idx_hi)
    fp_lo, fp_hi = _take(fp, idx_lo), _take(fp, idx_hi)
    denom = xp_hi - xp_lo
    pos = denom > 0
    frac = torch.clip(torch.where(
        pos, (x - xp_lo) / torch.where(pos, denom, 1.0), 0.0), 0, 1)
    return fp_lo + frac * (fp_hi - fp_lo)


def query(tq: torch.Tensor, t: torch.Tensor, y: torch.Tensor,
          outside_value: float = 0.0):
    """The step function (t, y) at locations tq."""
    idx_lo, idx_hi = searchsorted(t, tq)
    yq = _take(y, torch.clamp(idx_lo, max=y.shape[-1] - 1))
    return torch.where(idx_lo == idx_hi, outside_value, yq)


def inner_outer(t0: torch.Tensor, t1: torch.Tensor, y1: torch.Tensor):
    """Inner/outer measures of histogram (t1, y1) on bins t0: outer >= true
    mass >= inner per t0-bin."""
    cy1 = torch.cat([torch.zeros_like(y1[..., :1]), torch.cumsum(y1, -1)],
                    -1)
    idx_lo, idx_hi = searchsorted(t1, t0)
    cy1_lo, cy1_hi = _take(cy1, idx_lo), _take(cy1, idx_hi)
    y0_outer = cy1_hi[..., 1:] - cy1_lo[..., :-1]
    y0_inner = torch.where(idx_hi[..., :-1] <= idx_lo[..., 1:],
                           cy1_lo[..., 1:] - cy1_hi[..., :-1], 0.0)
    return y0_inner, y0_outer


def lossfun_outer(t, w, t_env, w_env):
    """Proposal-envelope loss: the nerf mass w above the envelope's outer
    measure."""
    _, w_outer = inner_outer(t, t_env, w_env)
    return torch.clamp(w - w_outer, min=0.0) ** 2 / (w + _EPS)


def weight_to_pdf(t, w):
    """Bin weights (sum 1) -> density (integral 1)."""
    return w / torch.clamp(t[..., 1:] - t[..., :-1], min=_EPS)


def pdf_to_weight(t, p):
    """Density -> bin weights."""
    return p * (t[..., 1:] - t[..., :-1])


def max_dilate(t, w, dilation, domain=(-math.inf, math.inf)):
    """Max-pool a non-negative step function with radius ``dilation``: new
    (sorted, domain-clipped) fenceposts of size 3n+1 and the dilated
    values between them."""
    lo = t[..., :-1] - dilation
    hi = t[..., 1:] + dilation
    t_d = torch.sort(torch.cat([t, lo, hi], -1), -1).values
    t_d = torch.clip(t_d, *domain)
    covers = ((lo[..., None, :] <= t_d[..., None])
              & (hi[..., None, :] > t_d[..., None]))      # [..., 3n+1, n]
    w_d = torch.where(covers, w[..., None, :], 0.0).amax(-1)[..., :-1]
    return t_d, w_d


def max_dilate_weights(t, w, dilation, domain=(-math.inf, math.inf),
                       renormalize: bool = False):
    """Dilate bin *weights* by max-pooling their density."""
    t_d, p_d = max_dilate(t, weight_to_pdf(t, w), dilation, domain=domain)
    w_d = pdf_to_weight(t_d, p_d)
    if renormalize:
        w_d = w_d / torch.clamp(w_d.sum(-1, keepdim=True), min=_EPS)
    return t_d, w_d


def integrate_weights(w: torch.Tensor):
    """CDF fenceposts of weights that sum to 1: exact 0 head and 1 tail."""
    cw = torch.clamp(torch.cumsum(w[..., :-1], -1), max=1.0)
    return torch.cat([torch.zeros_like(w[..., :1]), cw,
                      torch.ones_like(w[..., :1])], -1)


def invert_cdf(u: torch.Tensor, t: torch.Tensor, w_logits: torch.Tensor):
    """Inverse-CDF lookup of the step PDF softmax(w_logits) on bins t at
    quantiles u in [0, 1)."""
    cw = integrate_weights(torch.softmax(w_logits, -1))
    return sorted_interp(u, cw, t)


def sample(key, t: torch.Tensor, w_logits: torch.Tensor, num_samples: int,
           single_jitter: bool = False, deterministic_center: bool = False):
    """Piecewise-constant PDF sampling. ``key=None`` is the linspace path
    (optionally bin-centered); otherwise ``key`` is a ``torch.Generator``
    on t's device and the samples are stratified with a jitter from it
    (one per row with ``single_jitter``)."""
    dev = t.device
    if key is None:
        if deterministic_center:
            pad = 1.0 / (2 * num_samples)
            u = torch.linspace(pad, 1.0 - pad - _EPS, num_samples,
                               device=dev)
        else:
            u = torch.linspace(0.0, 1.0 - _EPS, num_samples, device=dev)
        u = u.expand(t.shape[:-1] + (num_samples,))
    else:
        u_max = _EPS + (1.0 - _EPS) / num_samples
        max_jitter = (1.0 - u_max) / (num_samples - 1) - _EPS
        d = 1 if single_jitter else num_samples
        jitter = torch.rand(t.shape[:-1] + (d,), generator=key,
                            device=dev) * max_jitter
        u = torch.linspace(0.0, 1.0 - u_max, num_samples, device=dev) + jitter
    return invert_cdf(u, t, w_logits)


def sample_intervals(key, t: torch.Tensor, w_logits: torch.Tensor,
                     num_samples: int, single_jitter: bool = False,
                     domain=(-math.inf, math.inf)):
    """Intervals spanning the midpoints of PDF samples: num_samples + 1
    fenceposts."""
    if num_samples <= 1:
        raise ValueError(f"num_samples must be > 1, is {num_samples}.")
    centers = sample(key, t, w_logits, num_samples, single_jitter,
                     deterministic_center=True)
    mid = 0.5 * (centers[..., 1:] + centers[..., :-1])
    minval, maxval = domain
    first = torch.clamp(2 * centers[..., :1] - mid[..., :1], min=minval)
    last = torch.clamp(2 * centers[..., -1:] - mid[..., -1:], max=maxval)
    return torch.cat([first, mid, last], -1)


def lossfun_distortion(t, w):
    """mip-NeRF 360 distortion: iint w_i w_j |t_i - t_j|."""
    ut = 0.5 * (t[..., 1:] + t[..., :-1])
    dut = (ut[..., :, None] - ut[..., None, :]).abs()
    loss_inter = (w * (w[..., None, :] * dut).sum(-1)).sum(-1)
    loss_intra = (w ** 2 * (t[..., 1:] - t[..., :-1])).sum(-1) / 3
    return loss_inter + loss_intra


def interval_distortion(t0_lo, t0_hi, t1_lo, t1_hi):
    """E|x - y| for x ~ U[t0_lo, t0_hi], y ~ U[t1_lo, t1_hi], in closed
    form, by whether the intervals overlap."""
    t0_lo, t0_hi, t1_lo, t1_hi = (torch.as_tensor(x, dtype=torch.float32)
                                  for x in (t0_lo, t0_hi, t1_lo, t1_hi))
    d_disjoint = (0.5 * (t1_lo + t1_hi) - 0.5 * (t0_lo + t0_hi)).abs()
    d_overlap = (2 * (torch.minimum(t0_hi, t1_hi) ** 3
                      - torch.maximum(t0_lo, t1_lo) ** 3)
                 + 3 * (t1_hi * t0_hi * (t1_hi - t0_hi).abs()
                        + t1_lo * t0_lo * (t1_lo - t0_lo).abs()
                        + t1_hi * t0_lo * (t0_lo - t1_hi)
                        + t1_lo * t0_hi * (t1_lo - t0_hi))) / (
        6 * (t0_hi - t0_lo) * (t1_hi - t1_lo))
    are_disjoint = (t0_lo > t1_hi) | (t1_lo > t0_hi)
    return torch.where(are_disjoint, d_disjoint, d_overlap)


def weighted_percentile(t, w, ps):
    """Percentiles (ps in [0, 100]) of the step CDF."""
    cw = integrate_weights(w)
    q = (torch.as_tensor(ps, dtype=t.dtype, device=t.device) / 100.0
         ).expand(t.shape[:-1] + (len(ps),))
    return sorted_interp(q, cw, t)


def resample(t, tp, vp, use_avg: bool = False):
    """Rebin step values (tp, vp) onto fenceposts t, mass-conserving (sum)
    or width-averaged."""
    if use_avg:
        wp = torch.diff(tp, dim=-1)
        v_numer = resample(t, tp, vp * wp, use_avg=False)
        v_denom = resample(t, tp, wp, use_avg=False)
        return v_numer / torch.clamp(v_denom, min=_EPS)
    acc0 = torch.cat([torch.zeros_like(vp[..., :1]), torch.cumsum(vp, -1)],
                     -1)
    return torch.diff(sorted_interp(t, tp, acc0), dim=-1)


def blur_stepfun(x, y, r):
    """Convolve step function (x, y) with a box of radius r: the result is
    piecewise-linear on the union of the shifted fenceposts, returned as
    (fenceposts, values at the posts)."""
    xr, idx = torch.sort(torch.cat([x - r, x + r], -1), dim=-1, stable=True)
    # slope deltas: +dy/2r at each left edge, -dy/2r at each right edge
    dy = (torch.cat([y, torch.zeros_like(y[..., :1])], -1)
          - torch.cat([torch.zeros_like(y[..., :1]), y], -1)) / (2 * r)
    slope_delta = _take(torch.cat([dy, -dy], -1), idx[..., :-1])
    yr = torch.clamp(torch.cumsum((xr[..., 1:] - xr[..., :-1])
                                  * torch.cumsum(slope_delta, -1), -1),
                     min=0.0)
    return xr, torch.cat([torch.zeros_like(yr[..., :1]), yr], -1)


# ---------------------------------------------------------------------
# Back-compat aliases of the first subset API.

def searchsorted_pair(t, v):
    """(lo, hi) of the interval around each query, hi = lo + 1."""
    idx = torch.searchsorted(t.contiguous(), v.contiguous(), right=True)
    hi = torch.clip(idx, 1, t.shape[-1] - 1)
    return hi - 1, hi


def weights_to_cdf(weights: torch.Tensor, eps: float = 1e-5):
    """Normalised inclusive CDF with a leading zero: [..., N] ->
    [..., N+1]."""
    w = weights + eps / weights.shape[-1]
    cdf = torch.cumsum(w, -1)
    cdf = cdf / cdf[..., -1:]
    return torch.cat([torch.zeros_like(cdf[..., :1]), cdf], -1)
