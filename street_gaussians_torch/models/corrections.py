"""Color and pose corrections, forward only.

Port of street_gaussians_tpu/models/corrections.py (the regularizers
and initializers that training needs come with the training slice).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

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


def apply_color_correction(params: ColorCorrectionParams, idx: int, rgb: torch.Tensor) -> torch.Tensor:
    """rgb [H, W, 3] -> corrected [H, W, 3] by the image's affine."""
    mat = params.affine[idx]  # [3, 4]
    return rgb @ mat[:, :3].T + mat[:, 3]


@dataclasses.dataclass
class PoseCorrectionParams:
    """Per-image SE(3) correction applied to the background Gaussians."""

    trans: torch.Tensor  # [N, 3]
    rots: torch.Tensor  # [N, 4] (w, x, y, z)


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
