"""The port's KITTI converter and KITTI-STEP mask scripts
(street_gaussians_torch/script/kitti/) against the repo's root scripts
(script/kitti/, run as subprocesses): a miniature raw KITTI tracking
sequence (write_raw_kitti, a copy of tests/test_kitti.py:29-110 with the
images written by cv2 as there) through both converters, every output
file byte-equal (the images copied, the text files, the tracklets) and
pointcloud.npz array-equal (its zip entries carry the write time); the
three mask CLIs pixel-equal on KITTI-STEP annotations in nested
directories; and the port's parser on the port's conversion."""

import filecmp
import json
import os
import subprocess
import sys

import cv2
import numpy as np
import pytest

from street_gaussians_torch.script.kitti import generate_dynamic_mask as t_dyn
from street_gaussians_torch.script.kitti import generate_semantic_mask as t_sem
from street_gaussians_torch.script.kitti import generate_sky_mask as t_skym
from street_gaussians_torch.script.kitti import kitti_converter as t_kitti

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KITTI_SCRIPTS = os.path.join(REPO, "script", "kitti")

H, W = 40, 60
NUM_FRAMES = 4


def write_raw_kitti(root, seq="0002"):
    """Miniature KITTI tracking training/ dir."""
    rng = np.random.default_rng(0)
    fx = fy = 50.0
    cx, cy = W / 2, H / 2
    K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]])
    # cam0 rectified: 4cm right of velodyne origin-ish; cam 3 with a
    # stereo baseline via P3's t = K^-1 P[:, 3]
    P2 = np.hstack([K, np.zeros((3, 1))])
    t3 = K @ np.array([-0.53, 0.0, 0.0])  # 53 cm baseline
    P3 = np.hstack([K, t3[:, None]])
    # velodyne -> cam0: cam x = -velo y, cam y = -velo z, cam z = velo x
    Tr_velo_cam = np.eye(4)
    Tr_velo_cam[:3, :3] = np.array([[0, -1, 0], [0, 0, -1], [1, 0, 0]])
    Tr_velo_cam[:3, 3] = [0.0, -0.08, -0.27]
    # imu -> velodyne: small forward offset, axes aligned
    Tr_imu_velo = np.eye(4)
    Tr_imu_velo[:3, 3] = [-0.8, 0.0, -0.3]
    R_rect = np.eye(3)

    os.makedirs(os.path.join(root, "calib"), exist_ok=True)
    with open(os.path.join(root, "calib", f"{seq}.txt"), "w") as f:
        z12 = " ".join(["0"] * 12)
        f.write(f"P0: {z12}\n")
        f.write(f"P1: {z12}\n")
        f.write("P2: " + " ".join(str(x) for x in P2.reshape(-1)) + "\n")
        f.write("P3: " + " ".join(str(x) for x in P3.reshape(-1)) + "\n")
        f.write("R_rect " + " ".join(str(x) for x in R_rect.reshape(-1)) + "\n")
        f.write(
            "Tr_velo_cam " + " ".join(str(x) for x in Tr_velo_cam[:3].reshape(-1)) + "\n"
        )
        f.write(
            "Tr_imu_velo " + " ".join(str(x) for x in Tr_imu_velo[:3].reshape(-1)) + "\n"
        )

    # oxts: drive north-ish with constant heading; 30 columns
    os.makedirs(os.path.join(root, "oxts"), exist_ok=True)
    lat0, lon0 = 49.0, 8.4
    rows = []
    for fidx in range(NUM_FRAMES):
        lat = lat0 + fidx * 2e-6  # ~0.22 m/frame north
        row = [lat, lon0, 112.0, 0.0, 0.0, np.pi / 2] + [0.0] * 24
        rows.append(row)
    np.savetxt(os.path.join(root, "oxts", f"{seq}.txt"), np.array(rows))

    for c, cam_dir in ((0, "image_02"), (1, "image_03")):
        d = os.path.join(root, cam_dir, seq)
        os.makedirs(d, exist_ok=True)
        for fidx in range(NUM_FRAMES):
            img = rng.uniform(0, 255, (H, W, 3)).astype(np.uint8)
            cv2.imwrite(os.path.join(d, f"{fidx:06d}.png"), img)

    # velodyne: points ahead of the car (+x in velo frame)
    vd = os.path.join(root, "velodyne", seq)
    os.makedirs(vd, exist_ok=True)
    for fidx in range(NUM_FRAMES):
        n = 300
        pts = np.stack(
            [
                rng.uniform(3, 25, n),
                rng.uniform(-8, 8, n),
                rng.uniform(-1.5, 2.0, n),
                rng.uniform(0, 1, n),
            ],
            axis=-1,
        ).astype(np.float32)
        pts.tofile(os.path.join(vd, f"{fidx:06d}.bin"))

    # label_02: one moving car in front (receding), one static van
    os.makedirs(os.path.join(root, "label_02"), exist_ok=True)
    lines = []
    for fidx in range(NUM_FRAMES):
        zc = 8.0 + 1.0 * fidx  # moving away in cam z
        lines.append(
            f"{fidx} 1 Car 0 0 0.0 10 10 30 30 1.5 1.7 4.1 0.5 1.2 {zc} 0.05"
        )
        lines.append(f"{fidx} 2 Van 0 0 0.0 10 10 30 30 1.9 1.8 4.8 -2.0 1.2 9.0 0.0")
    with open(os.path.join(root, "label_02", f"{seq}.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    return root




@pytest.fixture(scope="module")
def converted(tmp_path_factory):
    raw = str(tmp_path_factory.mktemp("kitti_raw"))
    write_raw_kitti(raw)
    jax_out = str(tmp_path_factory.mktemp("kitti_jax") / "0002")
    port_out = str(tmp_path_factory.mktemp("kitti_port") / "0002")
    r = subprocess.run([sys.executable, os.path.join(KITTI_SCRIPTS, "kitti_converter.py"), "--kitti_dir", raw,
                        "--seq", "0002", "--out_dir", jax_out], capture_output=True, text=True, timeout=300,
                       cwd=REPO)
    assert r.returncode == 0, r.stderr[-2000:]
    assert t_kitti.main(["--kitti_dir", raw, "--seq", "0002", "--out_dir", port_out]) == port_out
    return jax_out, port_out


@pytest.mark.parametrize("sub", ["images", "ego_pose", "intrinsics", "extrinsics", "track", "timestamps.json"])
def test_outputs_byte_equal(converted, sub):
    a, b = (os.path.join(d, sub) for d in converted)
    if os.path.isdir(a):
        names = sorted(os.listdir(a))
        assert names == sorted(os.listdir(b)) and names
        pairs = [(os.path.join(a, n), os.path.join(b, n)) for n in names]
    else:
        pairs = [(a, b)]
    for x, y in pairs:
        assert filecmp.cmp(x, y, shallow=False), (x, y)
    if sub == "track":
        with open(os.path.join(b, "track_camera_vis.json")) as f:
            assert "1" in json.load(f)


def test_pointcloud_array_equal(converted):
    a, b = (np.load(os.path.join(d, "pointcloud.npz"), allow_pickle=True) for d in converted)
    assert sorted(a.files) == sorted(b.files) == ["camera_projection", "pointcloud"]
    for key in a.files:
        x, y = a[key].item(), b[key].item()
        assert sorted(x) == sorted(y) == list(range(NUM_FRAMES))
        for f in x:
            assert x[f].dtype == y[f].dtype and x[f].shape == y[f].shape and len(x[f]) > 0
            np.testing.assert_array_equal(y[f], x[f])


def test_port_parser_reads_the_conversion(converted):
    from street_gaussians_torch.data import waymo

    out = waymo.generate_dataparser_outputs(converted[1], cameras=(0, 1), build_pointcloud=True,
                                            colmap_model_dir=None)
    assert waymo.num_sensors(converted[1]) == 2
    assert out.num_frames == NUM_FRAMES and len(out.image_filenames) == NUM_FRAMES * 2
    assert len(out.points_xyz_dict["bkgd"]) > 0


@pytest.fixture(scope="module")
def annotations(tmp_path_factory):
    """KITTI-STEP annotations (semantic id in the R channel), two levels of
    directories, every class of the colour map and the void label."""
    root = tmp_path_factory.mktemp("step")
    rng = np.random.default_rng(1)
    for rel in ("0002/000000.png", "0002/000001.png", "0003/sub/000000.png"):
        labels = rng.choice(np.array(list(range(19)) + [255], np.uint8), (H, W))
        labels[: H // 4] = 10
        bgr = rng.integers(0, 256, (H, W, 3)).astype(np.uint8)
        bgr[..., 2] = labels
        os.makedirs(os.path.dirname(str(root / rel)), exist_ok=True)
        cv2.imwrite(str(root / rel), bgr)
    return str(root)


@pytest.mark.parametrize("script,port", [("generate_sky_mask.py", t_skym), ("generate_dynamic_mask.py", t_dyn),
                                         ("generate_semantic_mask.py", t_sem)])
def test_step_mask_clis_pixel_equal(annotations, tmp_path, script, port):
    jax_out, port_out = str(tmp_path / "jax"), str(tmp_path / "port")
    r = subprocess.run([sys.executable, os.path.join(KITTI_SCRIPTS, script), "--annotation_path", annotations,
                        "--output_path", jax_out], capture_output=True, text=True, timeout=300,
                       env=dict(os.environ, PYTHONPATH=REPO))
    assert r.returncode == 0, r.stderr[-2000:]
    written = port.main(["--annotation_path", annotations, "--output_path", port_out])
    rels = sorted(os.path.relpath(p, port_out) for p in written)
    assert rels == ["0002/000000.png", "0002/000001.png", "0003/sub/000000.png"]
    for rel in rels:
        x = cv2.imread(os.path.join(jax_out, rel), cv2.IMREAD_UNCHANGED)
        y = cv2.imread(os.path.join(port_out, rel), cv2.IMREAD_UNCHANGED)
        assert x.shape == y.shape and x.dtype == y.dtype
        np.testing.assert_array_equal(y, x)
