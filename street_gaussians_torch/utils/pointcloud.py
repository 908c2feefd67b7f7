# Copied from street_gaussians_tpu/utils/pointcloud.py.
"""Point-cloud preprocessing (host-side numpy/scipy).

Replaces the reference's open3d usage for background cloud construction
(ref: lib/utils/waymo_utils.py:553-561: 0.15 m voxel downsample +
radius outlier removal nb_points=10 radius=0.5).
"""

from __future__ import annotations

import numpy as np
from scipy.spatial import cKDTree


def voxel_downsample(points: np.ndarray, colors: np.ndarray, voxel_size: float):
    """Average points/colors per occupied voxel (open3d
    voxel_down_sample semantics). Native C++ hash-grid when available."""
    if len(points) == 0:
        return points, colors
    from street_gaussians_torch import native

    out = native.voxel_downsample(points, colors, voxel_size)
    if out is not None:
        return out
    keys = np.floor(points / voxel_size).astype(np.int64)
    # unique voxel ids
    _, inv, counts = np.unique(keys, axis=0, return_inverse=True, return_counts=True)
    n_vox = counts.shape[0]
    sum_pts = np.zeros((n_vox, 3), np.float64)
    sum_rgb = np.zeros((n_vox, 3), np.float64)
    np.add.at(sum_pts, inv, points)
    np.add.at(sum_rgb, inv, colors)
    pts = (sum_pts / counts[:, None]).astype(np.float32)
    rgb = (sum_rgb / counts[:, None]).astype(np.float32)
    return pts, rgb


def remove_radius_outliers(
    points: np.ndarray, colors: np.ndarray, nb_points: int = 10, radius: float = 0.5
):
    """Keep points with >= nb_points neighbors within `radius`
    (open3d remove_radius_outlier semantics; the query point itself
    counts as a neighbor, matching open3d)."""
    if len(points) == 0:
        return points, colors
    from street_gaussians_torch import native

    counts = native.radius_outlier_counts(points, radius)
    if counts is None:
        tree = cKDTree(points)
        counts = tree.query_ball_point(
            points, r=radius, workers=-1, return_length=True
        )
    keep = counts >= nb_points
    return points[keep], colors[keep]


def sphere_norm(points: np.ndarray, scale: float = 1.0):
    """Scene-bounding sphere: center = midpoint of the AABB, radius =
    half the AABB diagonal x sphere_scale
    (ref: lib/datasets/base_readers.py:72-84 get_Sphere_Norm)."""
    xyz_max = points.max(axis=0)
    xyz_min = points.min(axis=0)
    center = (xyz_max + xyz_min) / 2.0
    radius = float(np.linalg.norm(xyz_max - xyz_min) / 2.0) * scale
    return center.astype(np.float32), radius


def nerfpp_norm(cam_centers: np.ndarray):
    """NeRF++ scene norm from camera centers: mean center, 1.1x the max
    distance (ref: lib/datasets/base_readers.py:30-55 getNerfppNorm)."""
    center = cam_centers.mean(axis=0)
    radius = float(np.linalg.norm(cam_centers - center[None], axis=-1).max()) * 1.1
    return center.astype(np.float32), radius
