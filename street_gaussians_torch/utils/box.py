# Copied from street_gaussians_tpu/utils/box.py.
"""3D box helpers (host-side numpy).

Re-implementation of the reference's box utilities
(ref: lib/utils/box_utils.py:1-65): bbox corner enumeration, in-box
tests, and the filled-polygon 2D projection mask used for the
`obj_bound` guidance images (ref: lib/utils/waymo_utils.py:407-437).
"""

from __future__ import annotations

import numpy as np

from street_gaussians_torch.utils.image_io import fill_poly


def bbox_to_corner3d(bbox) -> np.ndarray:
    """bbox [[min_xyz], [max_xyz]] -> 8 corners in the reference's
    ordering (ref: box_utils.py:35-49)."""
    min_x, min_y, min_z = bbox[0]
    max_x, max_y, max_z = bbox[1]
    return np.array(
        [
            [min_x, min_y, min_z],
            [min_x, min_y, max_z],
            [min_x, max_y, min_z],
            [min_x, max_y, max_z],
            [max_x, min_y, min_z],
            [max_x, min_y, max_z],
            [max_x, max_y, min_z],
            [max_x, max_y, max_z],
        ]
    )


def inbbox_points(points: np.ndarray, corner3d: np.ndarray) -> np.ndarray:
    """(ref: box_utils.py:57-63)"""
    min_xyz = corner3d[0]
    max_xyz = corner3d[-1]
    return np.logical_and(
        np.all(points >= min_xyz, axis=-1), np.all(points <= max_xyz, axis=-1)
    )


def get_bound_2d_mask(corners_3d, K, pose, H, W) -> np.ndarray:
    """Filled projection of a 3D box's 6 faces (ref: box_utils.py:4-17)."""
    corners_3d = np.dot(corners_3d, pose[:3, :3].T) + pose[:3, 3:].T
    corners_3d[..., 2] = np.clip(corners_3d[..., 2], a_min=1e-3, a_max=None)
    corners_3d = np.dot(corners_3d, K.T)
    corners_2d = corners_3d[:, :2] / corners_3d[:, 2:]
    corners_2d = np.round(corners_2d).astype(int)
    mask = np.zeros((H, W), dtype=np.uint8)
    for face in (
        [0, 1, 3, 2, 0],
        [4, 5, 7, 6, 5],
        [0, 1, 5, 4, 0],
        [2, 3, 7, 6, 2],
        [0, 2, 6, 4, 0],
        [1, 3, 7, 5, 1],
    ):
        fill_poly(mask, corners_2d[face], 1)
    return mask
