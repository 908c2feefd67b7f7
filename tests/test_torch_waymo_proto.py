"""The port's TFRecord reader (street_gaussians_torch/data/waymo_proto.py)
against the JAX package's (street_gaussians_tpu/data/waymo_proto.py):
the wire decoder, the packed int32 varints (decoded in numpy by the
port, one at a time by JAX), every record class field for field on
hand-encoded frames (a full one from data/synthetic_tfrecord.py and one
with every optional field missing), and project_to_pointcloud with and
without explicit beam inclinations at rtol 1e-6, atol 1e-6 (the port's
products on the CPU device). Also the imports of the data-preparation
modules."""

import os
import re
import struct
import zlib

import numpy as np
import pytest

from street_gaussians_torch.data import synthetic_tfrecord as st
from street_gaussians_torch.data import waymo_proto as tp
from street_gaussians_tpu.data import waymo_proto as jp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZES = {1: (24, 36), 2: (24, 36), 3: (24, 36), 4: (16, 36), 5: (16, 36)}
LASERS = {1: (8, 64), 2: (6, 24), 5: (6, 24)}


def fields_equal(a, b, where="frame"):
    """Every attribute of a port record equal to the JAX record's (arrays
    by value and dtype, nested records recursively)."""
    assert type(a).__name__ == type(b).__name__, where
    va, vb = vars(a), vars(b)
    assert sorted(va) == sorted(vb), where
    for k in va:
        x, y = va[k], vb[k]
        w = f"{where}.{k}"
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and x.shape == y.shape, w
            np.testing.assert_array_equal(x, y, err_msg=w)
        elif isinstance(x, list):
            assert len(x) == len(y), w
            for i, (p, q) in enumerate(zip(x, y)):
                fields_equal(p, q, f"{w}[{i}]")
        elif hasattr(x, "__dict__"):
            fields_equal(x, y, w)
        else:
            assert type(x) is type(y) and x == y, (w, x, y)


MESSAGES = {
    "scalars": st.f_varint(1, 5) + st.f_varint(1, 300) + st.f_double(2, -1.5) + st.f_float(3, 2.25)
    + st.f_bytes(4, b"abc") + st.f_varint(15, 2**40),
    "negative_varint": st.f_varint(1, -5) + st.f_varint(2, -(2**31)) + st.f_varint(3, 2**31 - 1),
    "nested_and_empty": st.f_bytes(7, st.f_bytes(1, b"")) + st.f_bytes(2, b"") + st.f_varint(100, 0),
    "empty": b"",
}


@pytest.mark.parametrize("name", sorted(MESSAGES))
def test_parse_message_matches_jax(name):
    buf = MESSAGES[name]
    assert tp.parse_message(buf) == jp.parse_message(buf)


PACKED = {
    "small": [0, 1, 127, 128, 255, 16383, 16384, 2**21, 2**28, 2**31 - 1],
    "negative": [-1, -2, -127, -128, -(2**31), -5, 3, -(2**20)],
    "camera_projection": list(np.random.default_rng(0).integers(-1, 1921, 600)),
    "empty": [],
}


@pytest.mark.parametrize("name", sorted(PACKED))
def test_packed_int32_matches_jax(name):
    """repeated int32 [packed]: the port decodes the blob in numpy, JAX one
    varint at a time; and the matrices of both."""
    blob = st.packed_varints(PACKED[name])
    a, b = tp._packed_i32_varint([blob]), jp._packed_i32_varint([blob])
    assert a.dtype == b.dtype == np.int32
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(a, np.asarray(PACKED[name], np.int64).astype(np.int32))
    if PACKED[name]:
        m = st.matrix_i32(PACKED[name], [len(PACKED[name])])
        np.testing.assert_array_equal(tp._matrix_i32(m), jp._matrix_i32(m))


def test_truncated_packed_varint_raises():
    with pytest.raises(ValueError, match="truncated"):
        tp._packed_i32_varint([b"\x05\x80"])


def minimal_frame() -> bytes:
    """A frame whose records miss every optional field: a context with a
    camera calibration of name only and a laser calibration with neither
    beams, range nor extrinsic; an image without pose or timestamp; a
    laser without a range image and one whose range image has no camera
    projection; a label without box or metadata and one whose metadata
    has speed_x alone; no frame pose."""
    ctx = st.f_bytes(2, st.f_varint(1, 2)) + st.f_bytes(3, st.f_varint(1, 1))
    ri = np.zeros((2, 3, 4), np.float32)
    ri[0, 1, 0] = 4.0
    ri[1, 2, 0] = 7.5
    rimg = st.f_bytes(2, zlib.compress(st.matrix_float(ri.reshape(-1), [2, 3, 4])))
    frame = st.f_bytes(1, ctx) + st.f_varint(2, 123)
    frame += st.f_bytes(4, st.f_varint(1, 2) + st.f_bytes(2, b"\x89PNG"))
    frame += st.f_bytes(5, st.f_varint(1, 3))
    frame += st.f_bytes(5, st.f_varint(1, 1) + st.f_bytes(2, rimg))
    frame += st.f_bytes(6, st.f_varint(3, 2) + st.f_bytes(4, b"p"))
    frame += st.f_bytes(6, st.f_bytes(1, st.f_double(1, 3.0)) + st.f_bytes(2, st.f_float(1, 1.5))
                        + st.f_bytes(4, b"q"))
    return frame


FRAMES = {
    "synthetic": lambda: st.encode_frame(1, SIZES, LASERS, st.default_labels(2, 2.0)),
    "missing_fields": minimal_frame,
}


@pytest.mark.parametrize("name", sorted(FRAMES))
def test_records_field_for_field(name):
    """Frame, CameraCalibration, LaserCalibration, CameraImage, Laser,
    RangeImage (and its decompressed range image and camera projection),
    Label and LabelBox: every field equal to the JAX reader's."""
    buf = FRAMES[name]()
    a, b = tp.Frame(buf), jp.Frame(buf)
    fields_equal(a, b)
    for la, lb in zip(a.lasers, b.lasers):
        if la.ri_return1 is None:
            assert lb.ri_return1 is None
            continue
        for what in ("range_image", "camera_projection"):
            x, y = getattr(la.ri_return1, what)(), getattr(lb.ri_return1, what)()
            assert (x is None) == (y is None), what
            if x is not None:
                assert x.dtype == y.dtype
                np.testing.assert_array_equal(x, y)
    if name == "missing_fields":
        assert a.images[0].pose_timestamp == 0.0 and np.array_equal(a.pose, np.eye(4))
        assert a.laser_labels[0].box is None and a.laser_labels[1].speed_x == 1.5
        assert a.lasers[0].ri_return1 is None and a.lasers[1].ri_return1.camera_projection() is None


def test_tfrecord_reader_and_get_by_name(tmp_path):
    path = str(tmp_path / "seg.tfrecord")
    st.write_synthetic_tfrecord(path, num_frames=3, camera_sizes=SIZES, laser_sizes=LASERS)
    fa, fb = list(tp.WaymoTFRecordReader(path)), list(jp.WaymoTFRecordReader(path))
    assert len(fa) == len(fb) == 3
    for x, y in zip(fa, fb):
        fields_equal(x, y)
        assert tp.get_by_name(x.laser_calibrations, 5).name == 5
    with pytest.raises(KeyError):
        tp.get_by_name(fa[0].laser_calibrations, 4)


@pytest.mark.parametrize("laser", [1, 2])
def test_project_to_pointcloud_matches_jax(laser):
    """Laser 1 (TOP) carries its beam inclinations, laser 2 its range
    (linspace from min to max); both with a turned extrinsic."""
    frame_buf = st.encode_frame(0, SIZES, {1: (16, 200), 2: (12, 40)}, [])
    a, b = tp.Frame(frame_buf), jp.Frame(frame_buf)
    la = next(x for x in a.lasers if x.name == laser)
    ri = la.ri_return1.range_image()
    ca = tp.get_by_name(a.laser_calibrations, laser)
    cb = jp.get_by_name(b.laser_calibrations, laser)
    assert (len(ca.beam_inclinations) > 0) == (laser == 1)
    pts, attrs = tp.project_to_pointcloud(a, ri, ca, device="cpu")
    want_pts, want_attrs = jp.project_to_pointcloud(b, ri, cb)
    assert pts.shape == want_pts.shape and 0 < pts.shape[0] < ri.shape[0] * ri.shape[1]
    np.testing.assert_allclose(pts, want_pts, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(attrs, want_attrs)
    # the converter stores float32: the same values
    np.testing.assert_allclose(pts.astype(np.float32), want_pts.astype(np.float32), rtol=1e-6, atol=1e-6)


DATA_PREP = ["data/waymo_proto.py", "data/synthetic_tfrecord.py", "network_gui.py",
             *(f"script/waymo/{m}.py" for m in ("waymo_converter", "generate_lidar_depth", "generate_sky_mask")),
             *(f"script/kitti/{m}.py" for m in ("kitti_converter", "kitti_step_masks", "generate_dynamic_mask",
                                                 "generate_semantic_mask", "generate_sky_mask"))]


def test_data_prep_modules_import_no_jax_tensorflow_onnx_or_top_level_cv2():
    """The data-preparation modules and the viewer import none of jax,
    the JAX package, tensorflow, onnxruntime or yaml, and cv2 only inside
    a function (utils/image_io's non-PNG decode; the JPEG codec of the
    test fixture writer)."""
    anywhere = re.compile(r"^\s*(import|from)\s+(jax|street_gaussians_tpu|tensorflow|onnxruntime|yaml)\b")
    top_level = re.compile(r"^(import|from)\s+cv2\b")
    bad = []
    for rel in DATA_PREP:
        with open(os.path.join(REPO, "street_gaussians_torch", rel)) as f:
            for n, line in enumerate(f, 1):
                if anywhere.match(line) or top_level.match(line):
                    bad.append(f"{rel}:{n}: {line.strip()}")
    assert not bad, bad
    with open(os.path.join(REPO, "street_gaussians_torch", "utils", "image_io.py")) as f:
        src = f.read()
    assert src.count("import cv2") == 2  # inside imread and imdecode, for non-PNG images


def test_struct_roundtrip_of_label_speeds():
    """Label metadata speeds are float32 on the wire: both readers give the
    float32 value back."""
    buf = st.f_bytes(2, st.f_float(1, 0.1) + st.f_float(2, -3.3)) + st.f_varint(3, 1) + st.f_bytes(4, b"x")
    a, b = tp.Label(buf), jp.Label(buf)
    assert (a.speed_x, a.speed_y) == (b.speed_x, b.speed_y) == (struct.unpack("<f", struct.pack("<f", 0.1))[0],
                                                                 struct.unpack("<f", struct.pack("<f", -3.3))[0])
