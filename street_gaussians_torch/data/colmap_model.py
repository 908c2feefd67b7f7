# Copied from street_gaussians_tpu/data/colmap_model.py.
"""COLMAP sparse-model readers (binary + text), numpy-only.

Fresh implementation of the standard COLMAP model format (the reference
vendors similar parsers at lib/utils/colmap_utils.py:104-320). Only the
pieces the pipeline consumes: points3D (SfM cloud merged into the
background init, waymo_utils.py:586-610) and cameras/images (for the
Colmap dataset type).
"""

from __future__ import annotations

import os
import struct
from typing import Dict, NamedTuple, Tuple

import numpy as np


class ColmapCamera(NamedTuple):
    id: int
    model: str
    width: int
    height: int
    params: np.ndarray


class ColmapImage(NamedTuple):
    id: int
    qvec: np.ndarray  # (w, x, y, z)
    tvec: np.ndarray
    camera_id: int
    name: str


CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3),
    1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5),
    4: ("OPENCV", 8),
    5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12),
    7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}


def qvec2rotmat(qvec: np.ndarray) -> np.ndarray:
    w, x, y, z = qvec
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


def read_points3d_binary(path: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """points3D.bin -> (xyz [N,3], rgb [N,3] float in [0,1], error [N])."""
    with open(path, "rb") as f:
        data = f.read()
    (num_points,) = struct.unpack_from("<Q", data, 0)
    off = 8
    xyz = np.empty((num_points, 3), np.float64)
    rgb = np.empty((num_points, 3), np.float64)
    err = np.empty((num_points,), np.float64)
    for i in range(num_points):
        vals = struct.unpack_from("<QdddBBBd", data, off)
        off += 43
        xyz[i] = vals[1:4]
        rgb[i] = vals[4:7]
        err[i] = vals[7]
        (track_len,) = struct.unpack_from("<Q", data, off)
        off += 8 + 8 * track_len
    return xyz.astype(np.float32), (rgb / 255.0).astype(np.float32), err.astype(np.float32)


def read_points3d_text(path: str):
    xyz, rgb, err = [], [], []
    with open(path) as f:
        for line in f:
            if line.startswith("#") or not line.strip():
                continue
            e = line.split()
            xyz.append([float(x) for x in e[1:4]])
            rgb.append([float(x) / 255.0 for x in e[4:7]])
            err.append(float(e[7]))
    return (
        np.array(xyz, np.float32),
        np.array(rgb, np.float32),
        np.array(err, np.float32),
    )


def read_points3d(model_dir: str):
    b = os.path.join(model_dir, "points3D.bin")
    t = os.path.join(model_dir, "points3D.txt")
    if os.path.exists(b):
        return read_points3d_binary(b)
    return read_points3d_text(t)


def read_cameras_binary(path: str) -> Dict[int, ColmapCamera]:
    with open(path, "rb") as f:
        data = f.read()
    (num,) = struct.unpack_from("<Q", data, 0)
    off = 8
    out = {}
    for _ in range(num):
        cid, model_id, w, h = struct.unpack_from("<iiQQ", data, off)
        off += 24
        name, nparams = CAMERA_MODELS[model_id]
        params = np.array(struct.unpack_from(f"<{nparams}d", data, off))
        off += 8 * nparams
        out[cid] = ColmapCamera(cid, name, int(w), int(h), params)
    return out


def read_images_binary(path: str) -> Dict[int, ColmapImage]:
    with open(path, "rb") as f:
        data = f.read()
    (num,) = struct.unpack_from("<Q", data, 0)
    off = 8
    out = {}
    for _ in range(num):
        vals = struct.unpack_from("<idddddddi", data, off)
        off += 64
        img_id = vals[0]
        qvec = np.array(vals[1:5])
        tvec = np.array(vals[5:8])
        cam_id = vals[8]
        name = b""
        while data[off : off + 1] != b"\x00":
            name += data[off : off + 1]
            off += 1
        off += 1
        (n2d,) = struct.unpack_from("<Q", data, off)
        off += 8 + 24 * n2d
        out[img_id] = ColmapImage(img_id, qvec, tvec, cam_id, name.decode())
    return out
