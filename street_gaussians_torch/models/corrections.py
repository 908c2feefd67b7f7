"""Color and pose corrections and their identity regularizers.

Port of street_gaussians_tpu/models/corrections.py.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from street_gaussians_torch._device import resolve_device
from street_gaussians_torch.utils.losses import jnp_abs
from street_gaussians_torch.utils.quaternion import (
    quat_multiply,
    quat_normalize,
    quat_to_rotmat,
)


@dataclasses.dataclass
class ColorCorrectionParams:
    """Per-image or per-sensor 3x4 affine color transforms."""

    affine: torch.Tensor  # [N, 3, 4]
    affine_sky: torch.Tensor  # [N, 3, 4]


def init_color_correction(num: int, device=None) -> ColorCorrectionParams:
    """num identity transforms on `device`."""
    eye = torch.eye(4, device=resolve_device(device))[:3].expand(num, 3, 4).contiguous()
    return ColorCorrectionParams(affine=eye, affine_sky=eye.clone())


def apply_color_correction(params: ColorCorrectionParams, idx: int, rgb: torch.Tensor) -> torch.Tensor:
    """rgb [H, W, 3] -> corrected [H, W, 3] by the image's affine."""
    mat = params.affine[idx]  # [3, 4]
    return rgb @ mat[:, :3].T + mat[:, 3]


def color_correction_reg(params: ColorCorrectionParams, idx: int) -> torch.Tensor:
    """Mean |affine - identity| of the image's two transforms (|x| with
    jnp's gradient: an identity transform sits exactly at 0)."""
    eye = torch.eye(4, device=params.affine.device)[:3]
    return jnp_abs(params.affine[idx] - eye).mean() + jnp_abs(params.affine_sky[idx] - eye).mean()


@dataclasses.dataclass
class PoseCorrectionParams:
    """Per-image SE(3) correction applied to the background Gaussians."""

    trans: torch.Tensor  # [N, 3]
    rots: torch.Tensor  # [N, 4] (w, x, y, z)


def init_pose_correction(num: int, device=None) -> PoseCorrectionParams:
    """num identity corrections on `device`."""
    device = resolve_device(device)
    rots = torch.zeros((num, 4), device=device)
    rots[:, 0] = 1.0
    return PoseCorrectionParams(trans=torch.zeros((num, 3), device=device), rots=rots)


def correct_gaussian_xyz(
    params: Optional[PoseCorrectionParams], idx: int, xyz: torch.Tensor
) -> torch.Tensor:
    if params is None:
        return xyz
    q = quat_normalize(params.rots[idx])
    R = quat_to_rotmat(q)
    return xyz @ R.T + params.trans[idx][None, :]


def correct_gaussian_rotation(
    params: Optional[PoseCorrectionParams], idx: int, rot: torch.Tensor
) -> torch.Tensor:
    if params is None:
        return rot
    q = quat_normalize(params.rots[idx])
    return quat_multiply(q[None, :], rot)


def pose_correction_reg(params: PoseCorrectionParams) -> torch.Tensor:
    """Mean |trans| plus mean |normalized rots - identity|."""
    target = torch.tensor([1.0, 0.0, 0.0, 0.0], device=params.rots.device)
    return jnp_abs(params.trans).mean() + jnp_abs(quat_normalize(params.rots) - target[None, :]).mean()
