"""3D -> 2D Gaussian covariance math (EWA splatting), port of the JAX
``ops/covariance.py`` (forward.cu computeCov3D:119-152,
computeCov2D:75-114). Component-wise on [P] vectors, in the same
operation order as the JAX package so float results agree to an ulp."""
from __future__ import annotations

import torch

# Low-pass filter added to the 2D covariance diagonal (forward.cu:110-113).
COV2D_DILATE = 0.3


def _quat_rot_elems(q: torch.Tensor):
    """Rotation matrix elements (9 [P] vectors, row-major) from [P,4] wxyz."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return (1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
            2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
            2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y))


def compute_cov3d(scales: torch.Tensor, quats: torch.Tensor,
                  scale_modifier: float = 1.0) -> torch.Tensor:
    """[P,3] activated scales + [P,4] wxyz quats -> [P,6] packed upper
    triangle (xx, xy, xz, yy, yz, zz) of Sigma3D."""
    r00, r01, r02, r10, r11, r12, r20, r21, r22 = _quat_rot_elems(quats)
    s0 = (scales[..., 0] * scale_modifier) ** 2
    s1 = (scales[..., 1] * scale_modifier) ** 2
    s2 = (scales[..., 2] * scale_modifier) ** 2
    xx = s0 * r00 * r00 + s1 * r01 * r01 + s2 * r02 * r02
    xy = s0 * r00 * r10 + s1 * r01 * r11 + s2 * r02 * r12
    xz = s0 * r00 * r20 + s1 * r01 * r21 + s2 * r02 * r22
    yy = s0 * r10 * r10 + s1 * r11 * r11 + s2 * r12 * r12
    yz = s0 * r10 * r20 + s1 * r11 * r21 + s2 * r12 * r22
    zz = s0 * r20 * r20 + s1 * r21 * r21 + s2 * r22 * r22
    return torch.stack([xx, xy, xz, yy, yz, zz], dim=-1)


def compute_cov2d(means3d: torch.Tensor, cov3d: torch.Tensor,
                  w2c: torch.Tensor, focal_x: float, focal_y: float,
                  tan_fovx: float, tan_fovy: float) -> torch.Tensor:
    """EWA projection of [P,6] packed Sigma3D to [P,3] (a, b, c) =
    (cov_xx, cov_xy, cov_yy), dilation included."""
    px, py, pz = means3d[..., 0], means3d[..., 1], means3d[..., 2]
    R = w2c[:3, :3]
    tvec = w2c[:3, 3]
    tx = R[0, 0] * px + R[0, 1] * py + R[0, 2] * pz + tvec[0]
    ty = R[1, 0] * px + R[1, 1] * py + R[1, 2] * pz + tvec[1]
    tz = R[2, 0] * px + R[2, 1] * py + R[2, 2] * pz + tvec[2]
    # splats behind the camera are culled but still traverse this math:
    # clamp tz so 1/tz stays finite
    tz = torch.clamp(tz, min=0.11)
    limx, limy = 1.3 * tan_fovx, 1.3 * tan_fovy
    tx = torch.clamp(tx / tz, -limx, limx) * tz
    ty = torch.clamp(ty / tz, -limy, limy) * tz

    inv_tz = 1.0 / tz
    jx = focal_x * inv_tz
    jy = focal_y * inv_tz
    jxz = -focal_x * tx * inv_tz * inv_tz
    jyz = -focal_y * ty * inv_tz * inv_tz
    m00 = jx * R[0, 0] + jxz * R[2, 0]
    m01 = jx * R[0, 1] + jxz * R[2, 1]
    m02 = jx * R[0, 2] + jxz * R[2, 2]
    m10 = jy * R[1, 0] + jyz * R[2, 0]
    m11 = jy * R[1, 1] + jyz * R[2, 1]
    m12 = jy * R[1, 2] + jyz * R[2, 2]

    xx, xy, xz = cov3d[..., 0], cov3d[..., 1], cov3d[..., 2]
    yy, yz, zz = cov3d[..., 3], cov3d[..., 4], cov3d[..., 5]
    u0 = xx * m00 + xy * m01 + xz * m02
    u1 = xy * m00 + yy * m01 + yz * m02
    u2 = xz * m00 + yz * m01 + zz * m02
    v0 = xx * m10 + xy * m11 + xz * m12
    v1 = xy * m10 + yy * m11 + yz * m12
    v2 = xz * m10 + yz * m11 + zz * m12
    a = m00 * u0 + m01 * u1 + m02 * u2 + COV2D_DILATE
    b = m00 * v0 + m01 * v1 + m02 * v2
    c = m10 * v0 + m11 * v1 + m12 * v2 + COV2D_DILATE
    return torch.stack([a, b, c], -1)


def conic_and_radius(cov2d: torch.Tensor, opacity=None):
    """Invert the 2D covariance and compute the 3-sigma pixel radius
    (forward.cu:219-232): (conic [P,3], radius [P] float, valid [P] bool).

    With ``opacity`` [P] a fourth tensor is returned: the opacity-aware
    binning radius sqrt(min(9, 2 ln(255 o) + 0.05) * lam_max), which bounds
    the blend's alpha >= 1/255 support and never exceeds the 3-sigma
    radius — bit-identical renders with fewer (tile, splat) pairs."""
    a, b, c = cov2d[..., 0], cov2d[..., 1], cov2d[..., 2]
    det = a * c - b * b
    valid = det > 0.0
    det_inv = torch.where(valid, 1.0 / torch.where(valid, det, 1.0),
                          torch.zeros_like(det))
    conic = torch.stack([c * det_inv, -b * det_inv, a * det_inv], -1)
    mid = 0.5 * (a + c)
    sq = torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    lam_max = mid + sq
    radius = torch.ceil(3.0 * torch.sqrt(torch.clamp(lam_max, min=0.0)))
    radius = torch.where(valid, radius, torch.zeros_like(radius))
    if opacity is None:
        return conic, radius, valid
    o = opacity.detach().reshape(-1)
    qmax = torch.clamp(2.0 * torch.log(torch.clamp(255.0 * o, min=1e-12))
                       + 0.05, max=9.0)
    r_bin = torch.ceil(torch.sqrt(torch.clamp(qmax, min=0.0)
                                  * torch.clamp(lam_max, min=0.0)))
    return conic, radius, valid, torch.where(valid, r_bin,
                                             torch.zeros_like(r_bin))
