# Copied from street_gaussians_tpu/utils/ply.py.
"""Minimal PLY reader/writer (ascii + binary_little_endian), numpy-only.

Replaces the reference's `plyfile` dependency (used at
lib/datasets/base_readers.py:87-113 fetchPly/storePly and the Gaussian
PLY export, lib/models/gaussian_model.py:80-155). Supports multiple
vertex elements per file — the composite model writes one
`vertex_<model_name>` element per sub-model
(ref: lib/models/street_gaussian_model.py:94-117).
"""

from __future__ import annotations

import io
from typing import Dict, List, Tuple

import numpy as np

_PLY_TO_NP = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}
_NP_TO_PLY = {
    "i1": "char", "u1": "uchar", "i2": "short", "u2": "ushort",
    "i4": "int", "u4": "uint", "f4": "float", "f8": "double",
}


def read_ply(path: str) -> Dict[str, np.ndarray]:
    """Read all elements; returns {element_name: structured array}."""
    with open(path, "rb") as f:
        data = f.read()
    header_end = data.find(b"end_header\n")
    if header_end < 0:
        raise ValueError(f"not a PLY file: {path}")
    header = data[:header_end].decode("ascii").splitlines()
    body = data[header_end + len(b"end_header\n"):]

    fmt = None
    elements: List[Tuple[str, int, List[Tuple[str, str]]]] = []
    for line in header:
        parts = line.strip().split()
        if not parts:
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            elements.append((parts[1], int(parts[2]), []))
        elif parts[0] == "property":
            if parts[1] == "list":
                raise ValueError("list properties not supported")
            elements[-1][2].append((parts[-1], _PLY_TO_NP[parts[1]]))

    out: Dict[str, np.ndarray] = {}
    if fmt == "ascii":
        text = body.decode("ascii").split()
        pos = 0
        for name, count, props in elements:
            ncol = len(props)
            vals = np.array(text[pos : pos + count * ncol], dtype=np.float64)
            pos += count * ncol
            arr = np.zeros(count, dtype=[(p, t) for p, t in props])
            vals = vals.reshape(count, ncol)
            for i, (p, _) in enumerate(props):
                arr[p] = vals[:, i]
            out[name] = arr
    elif fmt == "binary_little_endian":
        pos = 0
        for name, count, props in elements:
            dt = np.dtype([(p, "<" + t) for p, t in props])
            arr = np.frombuffer(body, dtype=dt, count=count, offset=pos)
            pos += dt.itemsize * count
            out[name] = arr
    else:
        raise ValueError(f"unsupported PLY format: {fmt}")
    return out


def write_ply(path: str, elements: Dict[str, np.ndarray]) -> None:
    """Write {element_name: structured array} as binary_little_endian."""
    buf = io.BytesIO()
    header = ["ply", "format binary_little_endian 1.0"]
    for name, arr in elements.items():
        header.append(f"element {name} {arr.shape[0]}")
        for field in arr.dtype.names:
            base = arr.dtype[field].str.lstrip("<>|=")
            header.append(f"property {_NP_TO_PLY[base]} {field}")
    header.append("end_header")
    buf.write(("\n".join(header) + "\n").encode("ascii"))
    for arr in elements.values():
        le = arr.astype(
            np.dtype([(n, "<" + arr.dtype[n].str.lstrip("<>|=")) for n in arr.dtype.names])
        )
        buf.write(le.tobytes())
    with open(path, "wb") as f:
        f.write(buf.getvalue())


def read_points_ply(path: str):
    """Read an xyz/rgb point cloud (ref: base_readers.py:87-97 fetchPly).

    Returns (points [N,3] f32, colors [N,3] f32 in [0,1], normals [N,3]).
    """
    elems = read_ply(path)
    v = elems.get("vertex", next(iter(elems.values())))
    pts = np.stack([v["x"], v["y"], v["z"]], axis=-1).astype(np.float32)
    names = v.dtype.names
    if "red" in names:
        cols = np.stack([v["red"], v["green"], v["blue"]], axis=-1).astype(np.float32)
        if v.dtype["red"].kind == "u":
            cols /= 255.0
    else:
        cols = np.ones_like(pts) * 0.5
    if "nx" in names:
        nrm = np.stack([v["nx"], v["ny"], v["nz"]], axis=-1).astype(np.float32)
    else:
        nrm = np.zeros_like(pts)
    return pts, cols, nrm


def write_points_ply(path: str, points: np.ndarray, colors: np.ndarray) -> None:
    """Write an xyz/rgb(uint8) cloud (ref: base_readers.py:99-113 storePly)."""
    n = points.shape[0]
    arr = np.zeros(
        n,
        dtype=[(k, "f4") for k in ("x", "y", "z", "nx", "ny", "nz")]
        + [(k, "u1") for k in ("red", "green", "blue")],
    )
    arr["x"], arr["y"], arr["z"] = points[:, 0], points[:, 1], points[:, 2]
    c = np.clip(colors * 255.0, 0, 255).astype(np.uint8) if colors.dtype.kind == "f" else colors
    arr["red"], arr["green"], arr["blue"] = c[:, 0], c[:, 1], c[:, 2]
    write_ply(path, {"vertex": arr})
