# Copied from street_gaussians_tpu/data/waymo_proto.py (lines 1-291), with the
# packed-int32 varints decoded in numpy (_packed_i32_varint) and the range-image
# projection's [H, W] products on a torch device in float64
# (project_to_pointcloud(..., device=)).
"""Waymo Open Dataset TFRecord reading WITHOUT TensorFlow or generated
protobuf code.

Replacement for the reference's vendored
`simple-waymo-open-dataset-reader` (ref: submodules/
simple-waymo-open-dataset-reader/__init__.py:19-91 record framing,
utils.py:216-344 range-image decoding): a minimal protobuf *wire-format*
decoder plus typed views over the handful of Frame fields the converter
consumes. Field numbers follow the public Apache-2.0 Waymo Open Dataset
schema (dataset.proto / label.proto).

Supported: Frame{context, timestamp_micros, pose, images, lasers,
laser_labels}; range-image decompression (zlib MatrixFloat/MatrixInt32)
and the spherical->cartesian pointcloud projection.

Parsing runs on the host. `project_to_pointcloud` takes `device=`: its
1-D azimuth and inclination tables and their cosines and sines come from
numpy (as the JAX package computes them), and the [H, W] products and
the extrinsic in float64 run on that device, in the order numpy's
broadcasts and einsum take them.
"""

from __future__ import annotations

import math
import struct
import zlib
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from street_gaussians_torch._device import resolve_device

# wire types
_VARINT, _I64, _LEN, _SGROUP, _EGROUP, _I32 = 0, 1, 2, 3, 4, 5


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def parse_message(buf: bytes) -> Dict[int, list]:
    """Decode one protobuf message into {field_number: [raw values]}.
    LEN fields stay bytes; VARINT -> int; I64/I32 -> raw 8/4 bytes."""
    fields: Dict[int, list] = {}
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        fnum, wt = tag >> 3, tag & 7
        if wt == _VARINT:
            val, pos = _read_varint(buf, pos)
        elif wt == _I64:
            val = buf[pos : pos + 8]
            pos += 8
        elif wt == _LEN:
            ln, pos = _read_varint(buf, pos)
            val = buf[pos : pos + ln]
            pos += ln
        elif wt == _I32:
            val = buf[pos : pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wt}")
        fields.setdefault(fnum, []).append(val)
    return fields


def _double(v) -> float:
    return struct.unpack("<d", v)[0]


def _repeated_double(vals) -> np.ndarray:
    """repeated double: packed (LEN blobs of 8k bytes) or unpacked (I64
    entries of 8 bytes) — both concatenate to the same layout."""
    if not vals:
        return np.zeros(0)
    return np.concatenate([np.frombuffer(v, "<f8") for v in vals])


def _packed_f32(vals) -> np.ndarray:
    return np.frombuffer(vals[0], "<f4") if vals else np.zeros(0, np.float32)


def _packed_i32_varint(vals) -> np.ndarray:
    """repeated int32 [packed]: varints in one LEN blob, decoded all at
    once: a varint ends at each byte below 0x80, and its 7-bit groups are
    summed at shifts 0, 7, 14, ... (negative int32s are 10-byte two's
    complements of 64 bits, whose low 32 bits are the value)."""
    if not vals or not len(vals[0]):
        return np.zeros(0, np.int32)
    b = np.frombuffer(vals[0], np.uint8)
    ends = np.flatnonzero(b < 0x80)
    if not len(ends) or ends[-1] != len(b) - 1:
        raise ValueError("truncated varint in a packed int32 field")
    starts = np.concatenate([[0], ends[:-1] + 1])
    pos_in = np.arange(len(b)) - np.repeat(starts, ends - starts + 1)
    groups = (b & 0x7F).astype(np.uint64) << (7 * pos_in).astype(np.uint64)
    return np.add.reduceat(groups, starts).astype(np.uint32).view(np.int32)


def _matrix_float(buf: bytes) -> np.ndarray:
    m = parse_message(buf)
    data = _packed_f32(m.get(1, []))
    dims = _packed_i32_varint(parse_message(m[2][0]).get(1, [])) if 2 in m else None
    return data.reshape(dims) if dims is not None else data


def _matrix_i32(buf: bytes) -> np.ndarray:
    m = parse_message(buf)
    data = _packed_i32_varint(m.get(1, []))
    dims = _packed_i32_varint(parse_message(m[2][0]).get(1, [])) if 2 in m else None
    return data.reshape(dims) if dims is not None else data


def _transform(buf: bytes) -> np.ndarray:
    m = parse_message(buf)
    return _repeated_double(m.get(1, [])).reshape(4, 4)


class CameraCalibration:
    """dataset.proto CameraCalibration (name=1, intrinsic=2,
    extrinsic=3, width=4, height=5)."""

    def __init__(self, buf: bytes):
        m = parse_message(buf)
        self.name = m.get(1, [0])[0]
        self.intrinsic = _repeated_double(m.get(2, []))
        self.extrinsic = _transform(m[3][0]) if 3 in m else np.eye(4)
        self.width = m.get(4, [0])[0]
        self.height = m.get(5, [0])[0]


class LaserCalibration:
    """LaserCalibration (name=1, beam_inclinations=2, min=3, max=4,
    extrinsic=5)."""

    def __init__(self, buf: bytes):
        m = parse_message(buf)
        self.name = m.get(1, [0])[0]
        self.beam_inclinations = _repeated_double(m.get(2, []))
        self.beam_inclination_min = _double(m[3][0]) if 3 in m else 0.0
        self.beam_inclination_max = _double(m[4][0]) if 4 in m else 0.0
        self.extrinsic = _transform(m[5][0]) if 5 in m else np.eye(4)


class CameraImage:
    """CameraImage (name=1, image=2, pose=3, pose_timestamp=5)."""

    def __init__(self, buf: bytes):
        m = parse_message(buf)
        self.name = m.get(1, [0])[0]
        self.image = m.get(2, [b""])[0]
        self.pose = _transform(m[3][0]) if 3 in m else np.eye(4)
        self.pose_timestamp = _double(m[5][0]) if 5 in m else 0.0


class RangeImage:
    """RangeImage (range_image_compressed=2,
    camera_projection_compressed=3, range_image_pose_compressed=4)."""

    def __init__(self, buf: bytes):
        m = parse_message(buf)
        self.range_image_compressed = m.get(2, [b""])[0]
        self.camera_projection_compressed = m.get(3, [b""])[0]
        self.range_image_pose_compressed = m.get(4, [b""])[0]

    def range_image(self) -> Optional[np.ndarray]:
        if not self.range_image_compressed:
            return None
        return _matrix_float(zlib.decompress(self.range_image_compressed))

    def camera_projection(self) -> Optional[np.ndarray]:
        if not self.camera_projection_compressed:
            return None
        return _matrix_i32(zlib.decompress(self.camera_projection_compressed))


class Laser:
    """Laser (name=1, ri_return1=2)."""

    def __init__(self, buf: bytes):
        m = parse_message(buf)
        self.name = m.get(1, [0])[0]
        self.ri_return1 = RangeImage(m[2][0]) if 2 in m else None


class LabelBox:
    """label.proto Label.Box (cx=1, cy=2, cz=3, width=4, length=5,
    height=6, heading=7)."""

    def __init__(self, buf: bytes):
        m = parse_message(buf)
        g = lambda k: _double(m[k][0]) if k in m else 0.0  # noqa: E731
        self.center_x, self.center_y, self.center_z = g(1), g(2), g(3)
        self.width, self.length, self.height = g(4), g(5), g(6)
        self.heading = g(7)


class Label:
    """Label (box=1, metadata=2 {speed_x=1, speed_y=2}, type=3, id=4)."""

    TYPE_VEHICLE, TYPE_PEDESTRIAN, TYPE_SIGN, TYPE_CYCLIST = 1, 2, 3, 4

    def __init__(self, buf: bytes):
        m = parse_message(buf)
        self.box = LabelBox(m[1][0]) if 1 in m else None
        self.type = m.get(3, [0])[0]
        self.id = m.get(4, [b""])[0].decode()
        self.speed_x = self.speed_y = 0.0
        if 2 in m:
            meta = parse_message(m[2][0])
            if 1 in meta:
                self.speed_x = struct.unpack("<f", meta[1][0])[0]
            if 2 in meta:
                self.speed_y = struct.unpack("<f", meta[2][0])[0]


class Frame:
    """Frame (context=1, timestamp_micros=2, pose=3, images=4, lasers=5,
    laser_labels=6)."""

    def __init__(self, buf: bytes):
        m = parse_message(buf)
        ctx = parse_message(m[1][0]) if 1 in m else {}
        self.camera_calibrations = [CameraCalibration(b) for b in ctx.get(2, [])]
        self.laser_calibrations = [LaserCalibration(b) for b in ctx.get(3, [])]
        self.timestamp_micros = m.get(2, [0])[0]
        self.pose = _transform(m[3][0]) if 3 in m else np.eye(4)
        self.images = [CameraImage(b) for b in m.get(4, [])]
        self.lasers = [Laser(b) for b in m.get(5, [])]
        self.laser_labels = [Label(b) for b in m.get(6, [])]


def get_by_name(items, name):
    """(ref: utils.py:346 get)"""
    for it in items:
        if it.name == name:
            return it
    raise KeyError(name)


class WaymoTFRecordReader:
    """TFRecord framing: 8-byte LE length + 4-byte masked crc + payload
    + 4-byte crc (ref: __init__.py:55-82; CRCs unchecked like the
    reference)."""

    def __init__(self, path: str):
        self.path = path

    def __iter__(self) -> Iterator[Frame]:
        with open(self.path, "rb") as f:
            while True:
                header = f.read(12)
                if len(header) < 12:
                    return
                (length,) = struct.unpack("<Q", header[:8])
                data = f.read(length)
                f.read(4)
                yield Frame(data)


# ---------------------------------------------------------------------------
# range image -> pointcloud (ref: utils.py:261-344)
# ---------------------------------------------------------------------------


def compute_beam_inclinations(calib: LaserCalibration, height: int) -> np.ndarray:
    if len(calib.beam_inclinations) > 0:
        return np.array(calib.beam_inclinations)
    return np.linspace(calib.beam_inclination_min, calib.beam_inclination_max, height)


def project_to_pointcloud(frame: Frame, ri: np.ndarray, calib: LaserCalibration, device=None):
    """Range image [H, W, C] -> (points_vehicle [N, 3] float64, attrs [N, C]),
    both numpy. The products run on `device` (the card unless the caller
    asks for the CPU) in float64: x = cos(az) cos(incl) range, y = sin(az)
    cos(incl) range, z = sin(incl) range, then the extrinsic's rows summed
    over x, y, z, 1 in that order, as numpy's einsum sums them."""
    dev = resolve_device(device)
    beam = np.flip(compute_beam_inclinations(calib, ri.shape[0]))
    extrinsic = calib.extrinsic

    height, width = ri.shape[:2]
    az_correction = math.atan2(extrinsic[1, 0], extrinsic[0, 0])
    azimuth = np.linspace(np.pi, -np.pi, width) - az_correction
    f64 = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.float64), device=dev)  # noqa: E731
    cos_az, sin_az = f64(np.cos(azimuth))[None, :], f64(np.sin(azimuth))[None, :]
    cos_in, sin_in = f64(np.cos(beam))[:, None], f64(np.sin(beam))[:, None]
    rng32 = torch.as_tensor(np.ascontiguousarray(ri[:, :, 0]), device=dev)
    rng = rng32.double()

    x = cos_az * cos_in * rng
    y = sin_az * cos_in * rng
    z = sin_in * rng
    e = f64(extrinsic)
    pts = torch.stack([((e[i, 0] * x + e[i, 1] * y) + e[i, 2] * z) + e[i, 3] for i in range(3)], dim=-1)

    mask = rng32 > 0
    return pts[mask].cpu().numpy(), ri[mask.cpu().numpy()]
