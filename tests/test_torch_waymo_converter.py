"""The port's Waymo converter and LiDAR depth
(street_gaussians_torch/script/waymo/{waymo_converter,generate_lidar_depth}.py,
device="cpu") against the repo's root scripts, run as JAX_PLATFORMS=cpu
subprocesses (as tests/test_converter.py runs them), on two TFRecords
written by data/synthetic_tfrecord.py: JPEG frames at Waymo's sizes
(1920x1280 and 1920x886) with a moving box beside and partly behind
each camera (corners clipped to z = 1e-3 project to ~10^6 px), and PNG
frames at a toy size. Text outputs byte-equal, images and dynamic masks
pixel-equal, the LiDAR points within rtol 1e-6 / atol 1e-6 and the
camera projections equal, the depth masks equal and their values at
rtol 1e-6; then the PNG sequence loads through the port's
load_waymo_scene with the names, frames and views the JAX package's
loader gives its own conversion."""

import filecmp
import os
import subprocess
import sys

import cv2
import numpy as np
import pytest

from street_gaussians_torch.data import synthetic_tfrecord as st
from street_gaussians_torch.script.waymo import generate_lidar_depth as t_depth
from street_gaussians_torch.script.waymo import waymo_converter as t_conv

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOY = {1: (24, 36), 2: (24, 36), 3: (24, 36), 4: (16, 36), 5: (16, 36)}
LASERS = {1: (16, 240), 3: (8, 40)}
VARIANTS = {"jpg": "000", "png": "001"}


def behind_camera_boxes(num_frames: int):
    """A moving box for each camera, beside its optical axis and
    straddling its image plane: 2 m of it in front, 2 m behind."""
    out = []
    for name in range(1, 6):
        _, ext = st.camera_calibration(name, *st.WAYMO_CAMERA_SIZES[name])
        yaw = st.CAMERA_YAW[name]
        c = ext[:3, 3] + ext[:3, :3] @ np.array([0.0, 0.8, 0.0])
        out.append({"id": f"beside-{name}", "type": 1, "speed": (2.0, 0.0),
                    "boxes": [(c[0], c[1], 1.2, 1.0, 4.0, 1.6, yaw) for _ in range(num_frames)]})
    return out


def jpeg_bytes(img: np.ndarray) -> bytes:
    ok, enc = cv2.imencode(".jpg", img)
    assert ok
    return enc.tobytes()


@pytest.fixture(scope="module")
def converted(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("waymo_raw"))
    st.write_synthetic_tfrecord(os.path.join(root, "seg-a.tfrecord"), num_frames=2, laser_sizes=LASERS,
                                labels=st.default_labels(2, 2.0) + behind_camera_boxes(2), encode=jpeg_bytes)
    st.write_synthetic_tfrecord(os.path.join(root, "seg-b.tfrecord"), num_frames=3, camera_sizes=TOY,
                                laser_sizes=LASERS)
    jax_dir, port_dir = str(tmp_path_factory.mktemp("jax_conv")), str(tmp_path_factory.mktemp("port_conv"))
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "script/waymo/waymo_converter.py", "--root_dir", root,
                        "--save_dir", jax_dir], capture_output=True, text=True, timeout=300, env=env, cwd=REPO)
    assert r.returncode == 0, r.stderr[-2000:]
    dirs = [os.path.join(jax_dir, v) for v in VARIANTS.values()]
    code = ("import importlib.util, sys\n"
            "spec = importlib.util.spec_from_file_location('gld', 'script/waymo/generate_lidar_depth.py')\n"
            "m = importlib.util.module_from_spec(spec); spec.loader.exec_module(m)\n"
            "for d in sys.argv[1:]: m.generate_lidar_depth(d)\n")
    r = subprocess.run([sys.executable, "-c", code, *dirs], capture_output=True, text=True, timeout=300, env=env,
                       cwd=REPO)
    assert r.returncode == 0, r.stderr[-2000:]
    stats = t_conv.main(["--root_dir", root, "--save_dir", port_dir, "--device", "cpu"])
    for v in VARIANTS.values():
        t_depth.main(["--datadir", os.path.join(port_dir, v), "--device", "cpu"])
    return {"jax": jax_dir, "port": port_dir, "stats": stats}


def pair(converted, variant, *rel):
    return (os.path.join(converted["jax"], VARIANTS[variant], *rel),
            os.path.join(converted["port"], VARIANTS[variant], *rel))


def listing(d):
    return sorted(os.listdir(d))


TEXT = ["intrinsics", "extrinsics", "ego_pose", "timestamps.json", "track/track_info.txt",
        "track/track_camera_vis.json"]


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("what", TEXT)
def test_text_outputs_byte_equal(converted, variant, what):
    a, b = pair(converted, variant, *what.split("/"))
    if os.path.isdir(a):
        names = listing(a)
        assert names == listing(b) and names
        files = [(os.path.join(a, n), os.path.join(b, n)) for n in names]
    else:
        files = [(a, b)]
    for x, y in files:
        assert filecmp.cmp(x, y, shallow=False), (x, y)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("what", ["images", "dynamic_mask"])
def test_images_and_dynamic_masks_pixel_equal(converted, variant, what):
    """cv2.imread of both (the port writes its PNGs through image_io)."""
    a, b = pair(converted, variant, what)
    names = listing(a)
    assert names == listing(b) and len(names) == 5 * (2 if variant == "jpg" else 3)
    marked = 0
    for n in names:
        x = cv2.imread(os.path.join(a, n), cv2.IMREAD_UNCHANGED)
        y = cv2.imread(os.path.join(b, n), cv2.IMREAD_UNCHANGED)
        assert x.shape == y.shape and x.dtype == y.dtype, n
        np.testing.assert_array_equal(x, y, err_msg=n)
        marked += what == "dynamic_mask" and x.any()
    if what == "dynamic_mask" and variant == "jpg":
        assert marked == len(names)  # every camera sees its box beside it
        assert cv2.imread(os.path.join(b, "000000_0.png")).shape[:2] == (1280, 1920)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_pointcloud_matches(converted, variant):
    a, b = pair(converted, variant, "pointcloud.npz")
    ja, pa = (np.load(p, allow_pickle=True) for p in (a, b))
    pc_a, pc_b = ja["pointcloud"].item(), pa["pointcloud"].item()
    pr_a, pr_b = ja["camera_projection"].item(), pa["camera_projection"].item()
    assert sorted(pc_a) == sorted(pc_b) == list(range(2 if variant == "jpg" else 3))
    for f in pc_a:
        assert pc_a[f].dtype == pc_b[f].dtype == np.float32 and pc_a[f].shape == pc_b[f].shape
        assert pc_a[f].shape[0] > 0
        np.testing.assert_allclose(pc_b[f], pc_a[f], rtol=1e-6, atol=1e-6)
        assert pr_a[f].dtype == pr_b[f].dtype == np.int16
        np.testing.assert_array_equal(pr_b[f], pr_a[f])
    stats = converted["stats"][f"seg-{'a' if variant == 'jpg' else 'b'}.tfrecord"]
    assert stats["points_per_frame"] == [pc_b[f].shape[0] for f in sorted(pc_b)]


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_lidar_depth_matches(converted, variant):
    a, b = pair(converted, variant, "lidar_depth")
    names = listing(a)
    assert names == listing(b) and len(names) == 5 * (2 if variant == "jpg" else 3)
    hits = 0
    for n in names:
        x = np.load(os.path.join(a, n), allow_pickle=True).item()
        y = np.load(os.path.join(b, n), allow_pickle=True).item()
        np.testing.assert_array_equal(y["mask"], x["mask"], err_msg=n)
        assert y["value"].dtype == x["value"].dtype == np.float32
        np.testing.assert_allclose(y["value"], x["value"], rtol=1e-6, err_msg=n)
        hits += int(x["mask"].sum())
    assert hits > 0


def test_loader_reads_converted(converted, tmp_path):
    """The port's load_waymo_scene on its own conversion of the PNG
    sequence gives the names, frames and views of the JAX loader on the
    JAX conversion (tests/test_converter.py:201-216: the moving vehicle
    kept, the sign filtered by class, 3 frames, 9 views of 3 cameras)."""
    from street_gaussians_torch.config import default_config as t_default_config
    from street_gaussians_torch.data.dataset import load_waymo_scene as t_load
    from street_gaussians_tpu.config import load_config as j_load_config
    from street_gaussians_tpu.data.dataset import load_waymo_scene as j_load

    scenes = {}
    for who, make, load in (("jax", j_load_config, j_load), ("port", t_default_config, t_load)):
        cfg = make()
        cfg.source_path = os.path.join(converted[who], VARIANTS["png"])
        cfg.model_path = str(tmp_path / who)
        cfg.data.split_train = 1
        cfg.data.cameras = [0, 1, 2]
        np.random.seed(0)
        scenes[who] = load(cfg, device="cpu") if who == "port" else load(cfg)
    j, t = scenes["jax"], scenes["port"]
    assert t.table.names == j.table.names and t.table.names[0] == "background" and len(t.table.names) == 2
    assert t.metadata["num_frames"] == j.metadata["num_frames"] == 3
    assert len(t.train_views) == len(j.train_views) == 9
    assert [v.image_name for v in t.train_views] == [v.image_name for v in j.train_views]
