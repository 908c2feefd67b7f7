"""Real spherical-harmonics basis and the Fourier time basis.

Port of street_gaussians_tpu/utils/sh.py (same constants and band layout).
"""

from __future__ import annotations

import math

import torch

C0 = 0.28209479177387814
C1 = 0.4886025119029199
C2 = (
    1.0925484305920792,
    -1.0925484305920792,
    0.31539156525252005,
    -1.0925484305920792,
    0.5462742152960396,
)
C3 = (
    -0.5900435899266435,
    2.890611442640554,
    -0.4570457994644658,
    0.3731763325901154,
    -0.4570457994644658,
    1.445305721320277,
    -0.5900435899266435,
)


def sh_basis(deg: int, dirs: torch.Tensor) -> torch.Tensor:
    """Basis values b [..., (deg+1)^2] so that eval = sum_k b_k * sh_k."""
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    cols = [C0 * torch.ones_like(x)]
    if deg > 0:
        cols += [-C1 * y, C1 * z, -C1 * x]
        if deg > 1:
            xx, yy, zz = x * x, y * y, z * z
            xy, yz, xz = x * y, y * z, x * z
            cols += [
                C2[0] * xy,
                C2[1] * yz,
                C2[2] * (2.0 * zz - xx - yy),
                C2[3] * xz,
                C2[4] * (xx - yy),
            ]
            if deg > 2:
                cols += [
                    C3[0] * y * (3.0 * xx - yy),
                    C3[1] * xy * z,
                    C3[2] * y * (4.0 * zz - xx - yy),
                    C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy),
                    C3[4] * x * (4.0 * zz - xx - yy),
                    C3[5] * z * (xx - yy),
                    C3[6] * x * (xx - 3.0 * yy),
                ]
    return torch.stack(cols, dim=-1)


def rgb_to_sh(rgb):
    """Works on numpy arrays and tensors alike."""
    return (rgb - 0.5) / C0


def sh_to_rgb(sh):
    """The inverse of rgb_to_sh; numpy arrays and tensors alike."""
    return sh * C0 + 0.5


def idft_basis(t: torch.Tensor, dim: int) -> torch.Tensor:
    """[..., dim]: cos(pi k t) for even k, sin(pi (k+1) t) for odd k."""
    t = t[..., None]
    k = torch.arange(dim, device=t.device)
    even = (k % 2) == 0
    return torch.where(
        even,
        torch.cos(math.pi * k * t),
        torch.sin(math.pi * (k + 1) * t),
    )
