# Copied from street_gaussians_tpu/native.py; the library is built from the same
# native/sgtpu_native.cpp into street_gaussians_torch/_build/native/.
"""ctypes loader/builder for the native host library (native/sgtpu_native.cpp).

Compiles on first use with g++ -O3 -fopenmp into a cached .so; every
entry point has a pure-Python (scipy/numpy) fallback so the framework
runs without a toolchain. The native paths matter at scene-build time:
kNN scale init over millions of LiDAR points (the reference's
simple-knn CUDA module) and the voxel/outlier background filtering
(the reference's open3d calls).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "native", "sgtpu_native.cpp")


def _build_dir() -> str:
    d = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build", "native")
    os.makedirs(d, exist_ok=True)
    return d


def load_native() -> Optional[ctypes.CDLL]:
    """Build (once) + load the native library; None when unavailable."""
    global _LIB, _TRIED
    with _LOCK:
        if _LIB is not None or _TRIED:
            return _LIB
        _TRIED = True
        if not os.path.exists(_SRC):
            return None
        so_path = os.path.join(_build_dir(), "libsgtpu_native.so")
        if not os.path.exists(so_path) or os.path.getmtime(so_path) < os.path.getmtime(_SRC):
            cmd = [
                "g++", "-O3", "-march=native", "-shared", "-fPIC", "-fopenmp",
                "-std=c++17", _SRC, "-o", so_path,
            ]
            try:
                subprocess.run(cmd, check=True, capture_output=True, timeout=120)
            except Exception:
                try:  # retry without -march/-fopenmp (portability)
                    subprocess.run(
                        ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", _SRC, "-o", so_path],
                        check=True, capture_output=True, timeout=120,
                    )
                except Exception:
                    return None
        try:
            lib = ctypes.CDLL(so_path)
        except OSError:
            return None

        lib.knn_mean_sq_dist3.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_float),
        ]
        lib.voxel_downsample.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.c_int64, ctypes.c_float,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ]
        lib.voxel_downsample.restype = ctypes.c_int64
        lib.radius_outlier_counts.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_float,
            ctypes.POINTER(ctypes.c_int32),
        ]
        _LIB = lib
        return _LIB


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def knn_mean_sq_dist3(points: np.ndarray) -> Optional[np.ndarray]:
    lib = load_native()
    if lib is None:
        return None
    pts = np.ascontiguousarray(points, np.float32)
    out = np.empty(pts.shape[0], np.float32)
    lib.knn_mean_sq_dist3(_fptr(pts), pts.shape[0], _fptr(out))
    return out


def voxel_downsample(points: np.ndarray, colors: np.ndarray, voxel: float):
    lib = load_native()
    if lib is None:
        return None
    pts = np.ascontiguousarray(points, np.float32)
    rgb = np.ascontiguousarray(colors, np.float32)
    out_p = np.empty_like(pts)
    out_c = np.empty_like(rgb)
    m = lib.voxel_downsample(_fptr(pts), _fptr(rgb), pts.shape[0], voxel, _fptr(out_p), _fptr(out_c))
    return out_p[:m].copy(), out_c[:m].copy()


def radius_outlier_counts(points: np.ndarray, radius: float) -> Optional[np.ndarray]:
    lib = load_native()
    if lib is None:
        return None
    pts = np.ascontiguousarray(points, np.float32)
    counts = np.empty(pts.shape[0], np.int32)
    lib.radius_outlier_counts(_fptr(pts), pts.shape[0], radius, counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return counts
