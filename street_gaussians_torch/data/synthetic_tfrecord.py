# Encoder adapted from the test-side protobuf writer of tests/test_converter.py
# (lines 19-146: _varint, _tag, f_varint, f_double, f_float, f_bytes,
# f_packed_doubles, matrix_float, matrix_i32, write_tfrecord), with the packed
# varints encoded in numpy and a ray-cast street scene in place of random data.
"""Write a synthetic Waymo Open Dataset TFRecord (no TensorFlow).

The raw-data counterpart of data/synthetic_waymo.py: where that module
writes a sequence already in the converted on-disk layout, this one
writes the `.tfrecord` a Waymo segment ships as, for the converter
(script/waymo/waymo_converter.py) to read. Fixture code for the tests
and chip_smoke.py, not a user feature.

The scene is a street: the ground at z = 0 and two building walls at y =
+-WALL_Y (world frame), 6 m tall, with the sky above them. The ego
drives along +x at `ego_speed` m a frame. Each camera image is ray-cast
against that scene (sky a bright, blue-ish band at the top, the walls
and the ground darker), each LiDAR range image too, and each LiDAR
return carries the camera projections of its point (the first two
cameras that see it), so depth, sky and colours agree across sensors.
Sizes, lasers, labels and the image encoder are arguments.
"""

from __future__ import annotations

import math
import os
import struct
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Optional, Sequence

import numpy as np

from street_gaussians_torch.utils.image_io import png_bytes

# Waymo's sensor sizes, (H, W) by camera name (1 FRONT, 2 FRONT_LEFT, 3
# FRONT_RIGHT, 4 SIDE_LEFT, 5 SIDE_RIGHT)
WAYMO_CAMERA_SIZES = {1: (1280, 1920), 2: (1280, 1920), 3: (1280, 1920), 4: (886, 1920), 5: (886, 1920)}
# camera yaw about the vehicle's z axis (0: looking along +x)
CAMERA_YAW = {1: 0.0, 2: math.pi / 4, 3: -math.pi / 4, 4: math.pi / 2, 5: -math.pi / 2}
# Waymo's range-image sizes (H beams, W columns) by laser name: TOP, FRONT,
# SIDE_LEFT, SIDE_RIGHT, REAR
WAYMO_LASER_SIZES = {1: (64, 2650), 2: (200, 600), 3: (200, 600), 4: (200, 600), 5: (200, 600)}
# laser placement on the vehicle: (x, y, z, yaw); max range in m
LASER_MOUNTS = {1: (1.43, 0.0, 2.18, 0.0061, 75.0), 2: (4.07, 0.0, 0.69, 0.0, 20.0),
                3: (3.25, 1.02, 0.98, math.pi / 2, 20.0), 4: (3.25, -1.02, 0.98, -math.pi / 2, 20.0),
                5: (-1.15, 0.0, 0.46, math.pi, 20.0)}
WALL_Y = 12.0
WALL_TOP = 6.0
SKY_BGR = (235, 206, 135)


# ---------------------------------------------------------------- protobuf wire encoding


def _varint(v: int) -> bytes:
    out = b""
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out += bytes([b | 0x80])
        else:
            return out + bytes([b])


def _tag(f: int, wt: int) -> bytes:
    return _varint((f << 3) | wt)


def f_varint(f: int, v: int) -> bytes:
    """A VARINT field; a negative int is its 10-byte two's complement."""
    return _tag(f, 0) + _varint(v & 0xFFFFFFFFFFFFFFFF)


def f_double(f: int, v: float) -> bytes:
    return _tag(f, 1) + struct.pack("<d", v)


def f_float(f: int, v: float) -> bytes:
    return _tag(f, 5) + struct.pack("<f", v)


def f_bytes(f: int, b: bytes) -> bytes:
    return _tag(f, 2) + _varint(len(b)) + b


def f_packed_doubles(f: int, vals) -> bytes:
    return f_bytes(f, np.asarray(vals, "<f8").tobytes())


def packed_varints(vals) -> bytes:
    """Packed int32 varints of vals, all at once: 7-bit groups, the high
    bit set on all but each value's last; negatives as 64-bit two's
    complements (10 bytes)."""
    u = np.asarray(vals, np.int64).reshape(-1).astype(np.uint64)
    n = np.ones(u.shape, np.int64)
    for k in range(1, 10):
        n += u >= np.uint64(1 << (7 * k))
    starts = np.concatenate([[0], np.cumsum(n)[:-1]])
    out = np.empty(int(n.sum()), np.uint8)
    for g in range(10):
        sel = n > g
        if not sel.any():
            break
        byte = (u[sel] >> np.uint64(7 * g)) & np.uint64(0x7F)
        byte |= np.where(n[sel] > g + 1, np.uint64(0x80), np.uint64(0))
        out[starts[sel] + g] = byte.astype(np.uint8)
    return out.tobytes()


def matrix_float(data, dims) -> bytes:
    shape = f_bytes(1, packed_varints(dims))
    return f_bytes(1, np.asarray(data, "<f4").tobytes()) + f_bytes(2, shape)


def matrix_i32(data, dims) -> bytes:
    shape = f_bytes(1, packed_varints(dims))
    return f_bytes(1, packed_varints(data)) + f_bytes(2, shape)


def write_tfrecord(path: str, frames: Sequence[bytes]) -> None:
    """TFRecord framing with zero CRCs (the reader does not check them)."""
    with open(path, "wb") as f:
        for data in frames:
            f.write(struct.pack("<Q", len(data)))
            f.write(b"\x00" * 4)
            f.write(data)
            f.write(b"\x00" * 4)


# ---------------------------------------------------------------- the scene


def _rot_z(yaw: float) -> np.ndarray:
    c, s = math.cos(yaw), math.sin(yaw)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


def camera_calibration(name: int, H: int, W: int):
    """(intrinsic [9], extrinsic [4, 4] camera-to-vehicle) of camera
    `name`: Waymo's camera frame (x forward, y left, z up), focal length
    1.08 W, mounted 1.5 m forward, 2.0 m up, turned by CAMERA_YAW."""
    f = 1.08 * W
    intr = np.array([f, f, W / 2.0, H / 2.0, -0.32, 0.12, 3e-4, -2e-4, 0.0])
    ext = np.eye(4)
    ext[:3, :3] = _rot_z(CAMERA_YAW[name])
    ext[:3, 3] = [1.5 + 0.05 * name, 0.12 * (name - 3), 2.0]
    return intr, ext


def _laser_extrinsic(name: int) -> np.ndarray:
    x, y, z, yaw, _ = LASER_MOUNTS[name]
    ext = np.eye(4)
    ext[:3, :3] = _rot_z(yaw)
    ext[:3, 3] = [x, y, z]
    return ext


def _laser_inclinations(name: int, H: int) -> np.ndarray:
    """Ascending beam inclinations, as the reader's linspace gives them."""
    if name == 1:
        return np.linspace(-0.31, 0.04, H)
    return np.linspace(-1.2, 0.5, H)


def _hit(origin, dx, dy, dz):
    """Ray cast in the world frame: origin (x, y, z), directions' components
    (arrays of one shape, any length) -> (t, kind: 0 sky, 1 ground, 2
    wall), t inf where the ray meets nothing."""
    t = np.full(dx.shape, np.inf, dx.dtype)
    kind = np.zeros(dx.shape, np.int8)
    with np.errstate(divide="ignore", invalid="ignore"):
        tg = -origin[2] / dz
        ok = (dz < 0) & (tg > 0)
        t[ok], kind[ok] = tg[ok], 1
        for wall in (WALL_Y, -WALL_Y):
            tw = (wall - origin[1]) / dy
            z = origin[2] + tw * dz
            ok = (tw > 0) & (tw < t) & (z >= 0) & (z <= WALL_TOP)
            t[ok], kind[ok] = tw[ok], 2
    return t, kind


def _colours(x, y, z, kind, rows) -> np.ndarray:
    """BGR uint8 [..., 3] of the hit points (x, y, z: world coordinates,
    rows: the pixel rows over H): sky (brightening towards the top rows),
    asphalt with lane marks, brown walls with windows."""
    out = np.empty(kind.shape + (3,), np.float32)
    sky = kind == 0
    out[sky] = np.asarray(SKY_BGR, np.float32) + (12 * (1 - np.broadcast_to(rows, kind.shape)[sky]))[:, None]
    g = kind == 1
    xg, yg = x[g], y[g]
    tex = 50 + 14 * np.sin(0.9 * xg) * np.sin(1.3 * yg) + 6 * np.sin(7.1 * xg + 3.3 * yg)
    lane = (np.abs(yg) < 0.12) & (np.mod(xg, 6.0) < 3.0)
    out[g] = np.where(lane, np.float32(95), tex)[:, None]
    w = kind == 2
    xw, zw = x[w], z[w]
    zm = np.mod(zw, 3.5)
    win = (np.mod(xw, 4.0) < 1.6) & (zm > 1.2) & (zm < 2.6)
    base = np.where(win, np.float32(28), 70 + 12 * np.sin(0.5 * xw + 0.9 * zw))
    out[w] = base[:, None] * np.array([0.7, 0.9, 1.2], np.float32)
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


def render_camera(name: int, H: int, W: int, ego_x: float) -> np.ndarray:
    """The BGR image [H, W, 3] camera `name` sees with the ego at x = ego_x
    (float32 rays through the pixel centres)."""
    intr, ext = camera_calibration(name, H, W)
    f, cx, cy = intr[0], intr[2], intr[3]
    a = (-(np.arange(W, dtype=np.float32) + 0.5 - cx) / f).astype(np.float32)[None, :]
    b = (-(np.arange(H, dtype=np.float32) + 0.5 - cy) / f).astype(np.float32)[:, None]
    R = ext[:3, :3].astype(np.float32)
    dx, dy, dz = (R[i, 0] + R[i, 1] * a + R[i, 2] * b for i in range(3))
    origin = ext[:3, 3] + np.array([ego_x, 0.0, 0.0])
    t, kind = _hit(origin.astype(np.float32), dx, dy, dz)
    t = np.where(np.isfinite(t), t, np.float32(0))
    x, y, z = (np.float32(origin[i]) + t * d for i, d in enumerate((dx, dy, dz)))
    rows = (np.arange(H, dtype=np.float32)[:, None] + 0.5) / H
    return _colours(x, y, z, kind, rows)


def _project(points_vehicle: np.ndarray, sizes: Dict[int, tuple]) -> np.ndarray:
    """Waymo's camera projection of each point: [N, 6] int (name, x, y of
    the first camera that sees it, then of the second; zeros where
    none)."""
    out = np.zeros((points_vehicle.shape[0], 6), np.int64)
    filled = np.zeros(points_vehicle.shape[0], np.int64)
    for name in sorted(sizes):
        H, W = sizes[name]
        intr, ext = camera_calibration(name, H, W)
        p = (points_vehicle - ext[:3, 3]) @ ext[:3, :3]
        with np.errstate(divide="ignore", invalid="ignore"):
            u = intr[2] - intr[0] * p[:, 1] / p[:, 0]
            v = intr[3] - intr[1] * p[:, 2] / p[:, 0]
        ok = (p[:, 0] > 0.1) & (u >= 0) & (u < W) & (v >= 0) & (v < H) & (filled < 2)
        for slot in (0, 1):
            s = ok & (filled == slot)
            out[s, 3 * slot] = name
            out[s, 3 * slot + 1] = u[s].astype(np.int64)
            out[s, 3 * slot + 2] = v[s].astype(np.int64)
        filled += ok
    return out


def range_image(name: int, H: int, W: int, ego_x: float, rng: np.random.Generator):
    """(range image [H, W, 4] float32, returns' vehicle-frame points [H, W,
    3]) of laser `name`: the scene ray-cast at the reader's azimuths and
    inclinations, up to the laser's range (0 beyond, as Waymo marks no
    return), with 2 cm of noise; channels range, intensity, elongation, 0."""
    ext = _laser_extrinsic(name)
    incl = np.flip(_laser_inclinations(name, H))
    az = np.linspace(np.pi, -np.pi, W) - math.atan2(ext[1, 0], ext[0, 0])
    d = np.stack([np.cos(az)[None, :] * np.cos(incl)[:, None], np.sin(az)[None, :] * np.cos(incl)[:, None],
                  np.broadcast_to(np.sin(incl)[:, None], (H, W))], axis=-1).reshape(-1, 3)
    dirs = d @ ext[:3, :3].T
    t, _ = _hit(ext[:3, 3] + np.array([ego_x, 0.0, 0.0]), dirs[:, 0], dirs[:, 1], dirs[:, 2])
    t = t + rng.normal(0.0, 0.02, t.shape)
    t = np.where(np.isfinite(t) & (t <= LASER_MOUNTS[name][4]), t, 0.0)
    ri = np.zeros((H, W, 4), np.float32)
    ri[..., 0] = t.reshape(H, W)
    ri[..., 1] = rng.uniform(0.0, 1.0, (H, W))
    ri[..., 2] = (t.reshape(H, W) > 0) * 0.1
    pts = (ext[:3, 3] + t[:, None] * dirs).reshape(H, W, 3)
    return ri, pts


def default_labels(num_frames: int, ego_speed: float):
    """A moving vehicle ahead of FRONT (3 m/s in the vehicle's x) and a
    static sign beside the road: dicts of id, type (1 vehicle, 3 sign),
    per-frame box (cx, cy, cz, width, length, height, heading) in the
    vehicle frame, and speed (x, y)."""
    return [
        {"id": "obj-a", "type": 1, "speed": (3.0, 0.5),
         "boxes": [(10.0 + 1.5 * f, -2.0, 0.8, 2.0, 4.5, 1.6, 0.1) for f in range(num_frames)]},
        {"id": "obj-b", "type": 3, "speed": (0.0, 0.0),
         "boxes": [(25.0 - ego_speed * f, 8.0, 2.5, 0.4, 0.4, 1.0, 0.0) for f in range(num_frames)]},
    ]


def encode_frame(frame_id: int, camera_sizes: Dict[int, tuple], laser_sizes: Dict[int, tuple],
                 labels, encode: Callable[[np.ndarray], bytes] = png_bytes, ego_speed: float = 2.0,
                 seed: int = 0) -> bytes:
    """One Frame message: context (camera and laser calibrations),
    timestamp, ego pose, camera images (encode(BGR uint8 [H, W, 3])),
    lasers (range image and camera projections, zlib-compressed), laser
    labels."""
    rng = np.random.default_rng([seed, frame_id])
    ego_x = ego_speed * frame_id
    ctx = b""
    for name in sorted(camera_sizes):
        H, W = camera_sizes[name]
        intr, ext = camera_calibration(name, H, W)
        ctx += f_bytes(2, f_varint(1, name) + f_packed_doubles(2, intr)
                       + f_bytes(3, f_packed_doubles(1, ext.reshape(-1))) + f_varint(4, W) + f_varint(5, H))
    for name in sorted(laser_sizes):
        H, _ = laser_sizes[name]
        lc = f_varint(1, name)
        if name == 1:  # TOP carries its beams; the others their range
            lc += f_packed_doubles(2, _laser_inclinations(name, H))
        else:
            incl = _laser_inclinations(name, H)
            lc += f_double(3, float(incl[0])) + f_double(4, float(incl[-1]))
        ctx += f_bytes(3, lc + f_bytes(5, f_packed_doubles(1, _laser_extrinsic(name).reshape(-1))))

    ego = np.eye(4)
    ego[:3, 3] = [ego_x, 0.0, 0.0]
    t_frame = 100.0 + 0.1 * frame_id
    frame = f_bytes(1, ctx) + f_varint(2, int(round(1e6 * t_frame)))
    frame += f_bytes(3, f_packed_doubles(1, ego.reshape(-1)))

    for name in sorted(camera_sizes):
        H, W = camera_sizes[name]
        data = encode(render_camera(name, H, W, ego_x))
        frame += f_bytes(4, f_varint(1, name) + f_bytes(2, data) + f_bytes(3, f_packed_doubles(1, ego.reshape(-1)))
                         + f_double(5, t_frame + 0.01 * name))

    for name in sorted(laser_sizes):
        H, W = laser_sizes[name]
        ri, pts = range_image(name, H, W, ego_x, rng)
        proj = _project(pts.reshape(-1, 3) - np.array([ego_x, 0.0, 0.0]), camera_sizes)
        proj[ri.reshape(-1, 4)[:, 0] <= 0] = 0
        rimg = (f_bytes(2, zlib.compress(matrix_float(ri.reshape(-1), [H, W, 4]), 1))
                + f_bytes(3, zlib.compress(matrix_i32(proj.reshape(-1), [H, W, 6]), 1)))
        frame += f_bytes(5, f_varint(1, name) + f_bytes(2, rimg))

    for lab in labels:
        cx, cy, cz, w, l, h, heading = lab["boxes"][frame_id]
        box = (f_double(1, cx) + f_double(2, cy) + f_double(3, cz) + f_double(4, w) + f_double(5, l)
               + f_double(6, h) + f_double(7, heading))
        msg = f_bytes(1, box)
        if any(lab["speed"]):
            msg += f_bytes(2, f_float(1, lab["speed"][0]) + f_float(2, lab["speed"][1]))
        frame += f_bytes(6, msg + f_varint(3, lab["type"]) + f_bytes(4, lab["id"].encode()))
    return frame


def write_synthetic_tfrecord(path: str, num_frames: int = 3, camera_sizes: Optional[Dict[int, tuple]] = None,
                             laser_sizes: Optional[Dict[int, tuple]] = None, labels=None,
                             encode: Callable[[np.ndarray], bytes] = png_bytes, ego_speed: float = 2.0,
                             seed: int = 0) -> str:
    """Write `num_frames` frames to path. camera_sizes: {camera name (1..5):
    (H, W)}, Waymo's sizes by default; laser_sizes: {laser name (1..5):
    (beams, columns)}, Waymo's by default; labels: as default_labels (the
    default), boxes given for every frame; encode: a BGR uint8 image to
    the bytes stored (image_io's PNG encoder by default; the tests pass
    cv2's JPEG encoder, as Waymo's segments hold JPEG). The frames are encoded in
    threads (numpy and zlib release the GIL). Returns path."""
    camera_sizes = dict(WAYMO_CAMERA_SIZES if camera_sizes is None else camera_sizes)
    laser_sizes = dict(WAYMO_LASER_SIZES if laser_sizes is None else laser_sizes)
    labels = default_labels(num_frames, ego_speed) if labels is None else labels
    with ThreadPoolExecutor(min(num_frames, os.cpu_count() or 1, 8)) as pool:
        frames = list(pool.map(lambda i: encode_frame(i, camera_sizes, laser_sizes, labels, encode, ego_speed,
                                                        seed), range(num_frames)))
    write_tfrecord(path, frames)
    return path
