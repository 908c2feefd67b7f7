"""The port's Colmap and Blender readers and its runner's scene build
against the JAX package's, with no render: the packed scene, every
view's camera, the views' metadata and the point cloud files the
readers write; build_initial_params and render_opts_from_cfg.

Tolerances: integers, bools, names and files equal; host float arrays
within 1e-6 (log_scale: the JAX package's native 3-NN sums float32
distances, the port's cKDTree float64 ones).
"""

import dataclasses
import filecmp
import os
import shutil

import numpy as np
import pytest

from street_gaussians_torch import runner as trunner
from street_gaussians_torch.config import default_config as t_default_config
from street_gaussians_tpu import runner as jrunner
from street_gaussians_tpu.config import default_config as j_default_config
from street_gaussians_tpu.utils import ply as ply_utils
from test_static_readers import _make_blender_dataset
from test_torch_waymo_loader import assert_same


def _make_colmap_dataset(root):
    """tests/test_static_readers.py's text model: 4 images, a PINHOLE
    camera, 200 points in points3D.ply."""
    from street_gaussians_torch.utils.image_io import imwrite

    os.makedirs(os.path.join(root, "sparse/0"), exist_ok=True)
    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    rng = np.random.default_rng(0)
    with open(os.path.join(root, "sparse/0/cameras.txt"), "w") as f:
        f.write("# cams\n1 PINHOLE 32 32 40 40 16 16\n")
    with open(os.path.join(root, "sparse/0/images.txt"), "w") as f:
        for i in range(4):
            imwrite(os.path.join(root, "images", f"img_{i}.png"), rng.integers(0, 255, (32, 32, 3), dtype=np.uint8))
            f.write(f"{i + 1} 1 0 0 0 {0.2 * i} 0 -3 1 img_{i}.png\n\n")
    pts = rng.uniform(-1, 1, (200, 3)).astype(np.float32)
    cols = rng.uniform(0, 1, (200, 3)).astype(np.float32)
    ply_utils.write_points_ply(os.path.join(root, "sparse/0/points3D.ply"), pts, cols)


def _configs(data_type, roots, **data):
    cfgs = []
    for default_config, root in zip((j_default_config, t_default_config), roots):
        cfg = default_config()
        cfg.source_path = root
        cfg.data.type = data_type
        for k, v in data.items():
            cfg.data[k] = v
        cfgs.append(cfg)
    return cfgs


def _assert_same_scene(js, ts):
    assert_same(js.params_init, ts.params_init, "params")
    assert_same(js.aux_init, ts.aux_init, "aux")
    for f in dataclasses.fields(js.table):
        w, g = getattr(js.table, f.name), getattr(ts.table, f.name)
        if isinstance(w, (int, float)):
            assert w == pytest.approx(g, rel=1e-6), f.name
        else:
            assert_same(w, g, f"table.{f.name}")
    assert_same(js.pose_data, ts.pose_data, "pose_data")
    assert [v.image_name for v in js.train_views] == [v.image_name for v in ts.train_views]
    assert [v.image_name for v in js.test_views] == [v.image_name for v in ts.test_views]
    for jv, tv in zip(js.all_views, ts.all_views):
        for k in ("H", "W", "cam", "frame", "frame_idx", "is_val", "timestamp"):
            assert getattr(jv, k) == getattr(tv, k), k
        assert os.path.basename(jv.image_path) == os.path.basename(tv.image_path)
        for k in ("w2c", "proj", "cam_center", "K"):
            assert_same(getattr(jv.frame_input.cam, k), getattr(tv.frame_input.cam, k), k)
        for k in ("ego_quat", "ego_rotmat", "ego_trans"):
            assert_same(getattr(jv.frame_input, k), getattr(tv.frame_input, k), k)
    for k, v in js.metadata.items():
        if isinstance(v, np.ndarray):
            np.testing.assert_array_equal(ts.metadata[k], v, err_msg=k)
        else:
            assert ts.metadata[k] == v, k


def test_colmap_text_scene_matches_jax(tmp_path):
    """The Colmap text model through runner.build_scene, split_test 4."""
    root = str(tmp_path / "colmap")
    _make_colmap_dataset(root)
    jcfg, tcfg = _configs("Colmap", (root, root), split_test=4)
    js, ts = jrunner.build_scene(jcfg), trunner.build_scene(tcfg, device="cpu")
    assert (len(ts.train_views), len(ts.test_views)) == (3, 1)
    _assert_same_scene(js, ts)


def test_blender_scene_matches_jax(tmp_path):
    """The Blender reader (RGBA images, the random initial cloud drawn
    from numpy's global generator and written to points3d.ply) through
    runner.build_scene, each package on its own copy of the dataset."""
    roots = [str(tmp_path / n) for n in ("jax", "torch")]
    _make_blender_dataset(roots[0])
    shutil.copytree(roots[0], roots[1])
    jcfg, tcfg = _configs("Blender", roots, eval=True)
    np.random.seed(0)
    js = jrunner.build_scene(jcfg)
    np.random.seed(0)
    ts = trunner.build_scene(tcfg, device="cpu")
    assert (len(ts.train_views), len(ts.test_views)) == (4, 2) and all(v.is_val for v in ts.test_views)
    assert ts.table.num_models == 1 and ts.table.capacity >= 100_000
    _assert_same_scene(js, ts)
    assert filecmp.cmp(*(os.path.join(r, "points3d.ply") for r in roots), shallow=False)


def test_synthetic_toy_scene_and_initial_params_match_jax():
    """runner.build_scene for SyntheticToy, then build_initial_params with
    the sky, colour and pose corrections on, and render_opts_from_cfg."""
    jcfg, tcfg = _configs("SyntheticToy", ("", ""), synthetic_kwargs=dict(
        num_bkgd=200, num_actors=2, H=32, W=48, seed=7, round_to=128))
    for cfg in (jcfg, tcfg):
        cfg.model.nsg.include_sky = True
        cfg.model.sky.resolution = 8
        cfg.model.use_color_correction = True
        cfg.model.use_pose_correction = True
        cfg.model.pose_correction.mode = "frame"
        cfg.render.tile_capacity = 0
        cfg.render.instance_capacity = 4096
        cfg.render.sky_downsample = 2
        cfg.data.white_background = True
    js, ts = jrunner.build_scene(jcfg), trunner.build_scene(tcfg, device="cpu")
    _assert_same_scene(js, ts)
    jp = jrunner.build_initial_params(jcfg, js)
    tp = trunner.build_initial_params(tcfg, ts, device="cpu")
    assert_same(jp, tp, "initial params")
    assert tp.color_correction.affine.shape == (8, 3, 4) and tp.pose_correction.rots.shape == (8, 4)
    for mode in ("train", "eval"):
        want = dataclasses.asdict(jrunner.render_opts_from_cfg(jcfg, mode))
        got = dataclasses.asdict(trunner.render_opts_from_cfg(tcfg, mode))
        assert {k: want[k] for k in got} == got
        assert got["tile_capacity"] == 4096 and got["white_background"]
