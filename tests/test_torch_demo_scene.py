"""The port's demo scene (street_gaussians_torch/script/make_demo_scene.py)
against the repo's root script/make_demo_scene.py, at toy size: 2 frames
of camera 0 at 64x96, 2,000 LiDAR points. The JAX script runs once as a
subprocess on the CPU, the port in-process on device="cpu"; numpy's
global generator is seeded before each (the tracked vehicle's grid
colours; it is out of every camera's view).

Tolerances, and why:
* pointcloud.npz (every frame's points and projections), the
  intrinsics, extrinsics, ego poses, tracks and timestamps: equal (the
  same numpy draws in the same order);
* the images: within one level (8-bit), where the two renders' rgb
  differ by a few ulp across a rounding edge (measured: one pixel of
  camera 0's two images off by one); the other sensors' random images
  equal;
* the sky masks (acc < 0.05): equal but where the ground truth's acc is
  within ACC_EPS of 0.05 (measured: equal everywhere); the LiDAR depth
  masks (acc > 0.5) likewise at 0.5, and the depths where both hold
  within DEPTH_ATOL metres (measured: 4.8e-6 on values up to ~60).
  The two packages' acc differ by the order of f32 sums, ~1e-7.
A 30-iteration run of the port's trainer on the port's scene raises
the train PSNR, and the root script/summarize_train_log.py reads its log.
"""

import contextlib
import io
import json
import os
import runpy
import subprocess
import sys

import numpy as np
import pytest

from street_gaussians_torch import train as ttrain_cli
from street_gaussians_torch.script.make_demo_scene import make_demo_scene
from street_gaussians_torch.utils.image_io import imread
from test_torch_runner import one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGS = dict(frames=2, cameras=(0,), height=64, width=96, points=2000, seed=0)
ACC_EPS = 1e-4
DEPTH_ATOL = 1e-4
ITERS = 30


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    root = tmp_path_factory.mktemp("demo")
    jdir, tdir = str(root / "jax"), str(root / "port")
    argv = ["make_demo_scene.py", "--out", jdir, "--frames", "2", "--cameras", "0", "--height", "64", "--width",
            "96", "--points", "2000", "--seed", "0"]
    code = ("import numpy, runpy, sys; numpy.random.seed(0); sys.argv = %r; "
            "runpy.run_path(%r, run_name='__main__')" % (argv, os.path.join(REPO, "script", "make_demo_scene.py")))
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    np.random.seed(0)
    accs = make_demo_scene(tdir, **ARGS, device="cpu")
    return jdir, tdir, accs


def _files(d):
    return sorted(os.listdir(d))


def test_geometry_and_lidar_cloud_equal(scenes):
    jdir, tdir, _ = scenes
    assert _files(jdir) == _files(tdir)
    for sub in ("intrinsics", "extrinsics", "ego_pose", "track"):
        assert _files(os.path.join(jdir, sub)) == _files(os.path.join(tdir, sub))
        for fn in _files(os.path.join(jdir, sub)):
            with open(os.path.join(jdir, sub, fn), "rb") as a, open(os.path.join(tdir, sub, fn), "rb") as b:
                assert a.read() == b.read(), f"{sub}/{fn}"
    with open(os.path.join(jdir, "timestamps.json")) as a, open(os.path.join(tdir, "timestamps.json")) as b:
        assert json.load(a) == json.load(b)
    ja = np.load(os.path.join(jdir, "pointcloud.npz"), allow_pickle=True)
    ta = np.load(os.path.join(tdir, "pointcloud.npz"), allow_pickle=True)
    assert ja.files == ta.files == ["pointcloud", "camera_projection"]
    for k in ja.files:
        jd, td = ja[k].item(), ta[k].item()
        assert sorted(jd) == sorted(td) == [0, 1]
        for f in jd:
            assert jd[f].dtype == td[f].dtype and np.array_equal(jd[f], td[f]), (k, f)
    assert not os.path.exists(os.path.join(tdir, "_gt_build"))


def test_images_within_one_level(scenes):
    jdir, tdir, accs = scenes
    names = _files(os.path.join(jdir, "images"))
    assert names == _files(os.path.join(tdir, "images")) and len(names) == 10
    for fn in names:
        a = imread(os.path.join(jdir, "images", fn)).astype(int)
        b = imread(os.path.join(tdir, "images", fn)).astype(int)
        assert a.shape == b.shape == (64, 96, 3)
        if fn[:-4] in accs:  # camera 0: rendered
            assert np.abs(a - b).max() <= 1, fn
        else:
            assert np.array_equal(a, b), fn


def test_sky_masks_and_lidar_depth(scenes):
    jdir, tdir, accs = scenes
    assert sorted(accs) == ["000000_0", "000001_0"]
    assert _files(os.path.join(jdir, "lidar_depth")) == _files(os.path.join(tdir, "lidar_depth"))
    for name, acc in accs.items():
        js = imread(os.path.join(jdir, "sky_mask", name + ".png"), unchanged=True)
        ts = imread(os.path.join(tdir, "sky_mask", name + ".png"), unchanged=True)
        np.testing.assert_array_equal(ts, ((acc < 0.05) * 255).astype(np.uint8))
        edge = np.abs(acc - 0.05) < ACC_EPS
        assert np.array_equal(js[~edge], ts[~edge]), name
        jd = np.load(os.path.join(jdir, "lidar_depth", name + ".npy"), allow_pickle=True).item()
        td = np.load(os.path.join(tdir, "lidar_depth", name + ".npy"), allow_pickle=True).item()
        edge = np.abs(acc - 0.5) < ACC_EPS
        assert np.array_equal(jd["mask"][~edge], td["mask"][~edge]), name
        both = jd["mask"] & td["mask"]
        assert both.sum() > 0.3 * acc.size
        jv = np.zeros(acc.shape, np.float32)
        tv = np.zeros(acc.shape, np.float32)
        jv[jd["mask"]], tv[td["mask"]] = jd["value"], td["value"]
        np.testing.assert_allclose(tv[both], jv[both], rtol=0, atol=DEPTH_ATOL)


def test_port_trains_on_the_demo_scene(scenes, tmp_path):
    """configs/demo_synthetic.yaml on the port's toy scene for ITERS
    iterations (sky cubemap 32, no densify): the eval train PSNR rises
    from the first step's, and the root summarize_train_log.py reads the
    port's log as it is."""
    _, tdir, _ = scenes
    out = str(tmp_path / "out")
    np.random.seed(0)
    ttrain_cli.main(["--config", os.path.join(REPO, "configs", "demo_synthetic.yaml"), "--device", "cpu",
                     "source_path", tdir, "model_path", out, "model.sky.resolution", "32",
                     "train.iterations", str(ITERS), "train.test_iterations", f"[1, {ITERS}]",
                     "train.save_iterations", "[]", "train.checkpoint_iterations", "[]"])
    log = os.path.join(out, "record", "train_log.jsonl")
    with open(log) as f:
        recs = [json.loads(line) for line in f]
    evals = {r["iteration"]: r["train_psnr"] for r in recs if "train_psnr" in r}
    assert sorted(evals) == [1, ITERS]
    assert evals[ITERS] > evals[1] + 3.0, evals
    summarize = runpy.run_path(os.path.join(REPO, "script", "summarize_train_log.py"))["main"]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        summarize(log)
    text = buf.getvalue()
    assert f"{ITERS // 10} scalar records, 0 densify rounds, 0 events" in text, text
    last = [r for r in recs if "loss" in r][-1]
    assert f"| {ITERS} | {last['psnr']:.2f} | {last['loss']:.4f} | {int(last['num_alive'])} | 0/0 |" in text, text
