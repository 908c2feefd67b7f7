# Copied from street_gaussians_tpu/utils/knn.py (scipy path only).
"""Nearest-neighbor distances for Gaussian scale initialization.

Init-time and host-side: an exact scipy cKDTree query for the mean
squared distance to the 3 nearest neighbors of each point. (The JAX
package may take a native exact 3-NN instead; it is tested against this
cKDTree path.) Returns numpy.
"""

from __future__ import annotations

import numpy as np
from scipy.spatial import cKDTree


def mean_sq_dist_to_3nn(points: np.ndarray) -> np.ndarray:
    """points [N, 3] -> [N] mean squared distance to the 3 nearest
    neighbors (excluding self), clamped to >= 1e-7."""
    points = np.asarray(points)
    n = points.shape[0]
    if n == 0:
        return np.zeros((0,), np.float32)
    k = min(4, n)  # self + up to 3 neighbors
    tree = cKDTree(np.asarray(points, np.float64))
    dist, _ = tree.query(points, k=k, workers=-1)
    if k == 1:
        d2 = np.full((n,), 1e-7)
    else:
        d2 = np.mean(dist[:, 1:] ** 2, axis=1)
    return np.maximum(d2, 1e-7).astype(np.float32)


def initial_log_scales(points: np.ndarray) -> np.ndarray:
    """log(sqrt(mean_sq_dist_3nn)) broadcast to 3 axes."""
    d2 = mean_sq_dist_to_3nn(points)
    s = np.log(np.sqrt(d2))
    return np.repeat(s[:, None], 3, axis=1).astype(np.float32)
