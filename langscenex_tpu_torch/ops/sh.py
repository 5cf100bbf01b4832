"""Spherical harmonics evaluation (real SH, degrees 0-4), port of the JAX
``ops/sh.py`` (reference: sh_utils.py and forward.cu:21-74)."""
from __future__ import annotations

import torch

C0 = 0.28209479177387814
C1 = 0.4886025119029199
C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
      -1.0925484305920792, 0.5462742152960396)
C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
      0.3731763325901154, -0.4570457994644658, 1.445305721320277,
      -0.5900435899266435)
C4 = (2.5033429417967046, -1.7701307697799304, 0.9461746957575601,
      -0.6690465435572892, 0.10578554691520431, -0.6690465435572892,
      0.47308734787878004, -1.7701307697799304, 0.6258357354491761)


def sh_basis(deg: int, x: torch.Tensor, y: torch.Tensor, z: torch.Tensor):
    """Real SH basis values as a list of (deg+1)^2 tensors shaped like x."""
    basis = [torch.full_like(x, C0)]
    if deg > 0:
        basis += [-C1 * y, C1 * z, -C1 * x]
        if deg > 1:
            xx, yy, zz = x * x, y * y, z * z
            xy, yz, xz = x * y, y * z, x * z
            basis += [C2[0] * xy, C2[1] * yz, C2[2] * (2 * zz - xx - yy),
                      C2[3] * xz, C2[4] * (xx - yy)]
            if deg > 2:
                basis += [C3[0] * y * (3 * xx - yy), C3[1] * xy * z,
                          C3[2] * y * (4 * zz - xx - yy),
                          C3[3] * z * (2 * zz - 3 * xx - 3 * yy),
                          C3[4] * x * (4 * zz - xx - yy),
                          C3[5] * z * (xx - yy), C3[6] * x * (xx - 3 * yy)]
                if deg > 3:
                    basis += [C4[0] * xy * (xx - yy),
                              C4[1] * yz * (3 * xx - yy),
                              C4[2] * xy * (7 * zz - 1),
                              C4[3] * yz * (7 * zz - 3),
                              C4[4] * (zz * (35 * zz - 30) + 3),
                              C4[5] * xz * (7 * zz - 3),
                              C4[6] * (xx - yy) * (7 * zz - 1),
                              C4[7] * xz * (xx - 3 * yy),
                              C4[8] * (xx * (xx - 3 * yy)
                                       - yy * (3 * xx - yy))]
    return basis


def sh_to_rgb_fast(deg: int, shs: torch.Tensor, dx, dy, dz) -> torch.Tensor:
    """Clamped SH->RGB on [P,K,3] coefficients with direction components
    given as [P] vectors (forward.cu:65-73: result + 0.5, clamped >= 0)."""
    basis = sh_basis(deg, dx, dy, dz)
    chans = []
    for c in range(3):
        acc = basis[0] * shs[:, 0, c]
        for k in range(1, len(basis)):
            acc = acc + basis[k] * shs[:, k, c]
        chans.append(acc)
    rgb = torch.stack(chans, -1)
    return torch.clamp(rgb + 0.5, min=0.0)


def rgb_to_sh(rgb: torch.Tensor) -> torch.Tensor:
    """(rgb - 0.5)/C0 — DC coefficient init (sh_utils.py RGB2SH)."""
    return (rgb - 0.5) / C0
