"""The port's Waymo-format loading against the JAX package's: the
synthetic sequence writer, the dataparser, the scene build, the ground
truth, one render of a loaded view, and the native host library.

Both packages read one sequence written by the JAX package's writer
(module fixture); numpy's global generator is seeded identically before
each package's load (the actor takes the grid initialisation, whose
colours it draws). Tolerances: integers, masks and file contents equal;
host float arrays within 1e-6 (log_scale: the JAX package's native 3-NN
sums float32 distances, the port's cKDTree float64 ones, so 1e-6
absolute); the render as tests/test_torch_render.py (rtol = atol = 1e-5).
"""

import dataclasses
import filecmp
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from street_gaussians_torch import native as tnative
from street_gaussians_torch import runner as trunner
from street_gaussians_torch.config import default_config as t_default_config
from street_gaussians_torch.data import dataset as tds
from street_gaussians_torch.data import waymo as twaymo
from street_gaussians_torch.data.synthetic_waymo import write_synthetic_waymo as t_write
from street_gaussians_torch.models import renderer as trend
from street_gaussians_torch.utils.image_io import imread
from street_gaussians_tpu import native as jnative
from street_gaussians_tpu.config import default_config as j_default_config
from street_gaussians_tpu.data import dataset as jds
from street_gaussians_tpu.data import waymo as jwaymo
from street_gaussians_tpu.data.synthetic_waymo import write_synthetic_waymo as j_write
from street_gaussians_tpu.models import renderer as jrend

HOST = dict(rtol=0, atol=1e-6)
RENDER = dict(rtol=1e-5, atol=1e-5)


def _cfg(default_config, root, model_path, split_test=-1):
    cfg = default_config()
    cfg.source_path = root
    cfg.model_path = model_path
    cfg.mode = "train"
    cfg.data.type = "Waymo"
    cfg.data.split_train = 1 if split_test < 0 else -1
    cfg.data.split_test = split_test
    cfg.data.cameras = [0, 1, 2]
    cfg.optim.lambda_sky_scale = [1.0, 1.0, 0.0]
    return cfg


def assert_same(want, got, name, tol=HOST):
    """A JAX/numpy value (dataclass, array or Python value) against the
    port's (tensors on the CPU): integers and bools equal, floats within
    tol."""
    if dataclasses.is_dataclass(want):
        for f in dataclasses.fields(want):
            assert_same(getattr(want, f.name), getattr(got, f.name), f"{name}.{f.name}", tol)
        return
    if isinstance(got, torch.Tensor):
        got = got.numpy()
    if isinstance(want, (list, tuple, str)) or want is None:
        assert want == got, name
        return
    want, got = np.asarray(want), np.asarray(got)
    assert want.shape == got.shape, name
    if want.dtype.kind in "biuU" or got.dtype.kind in "biuU":
        np.testing.assert_array_equal(got, want, err_msg=name)
    else:
        np.testing.assert_allclose(got, want, err_msg=name, **tol)


@pytest.fixture(scope="module")
def seq(tmp_path_factory):
    """One 4-frame sequence from the JAX writer, loaded by both packages
    (all frames training views, and every second frame held out)."""
    root = str(tmp_path_factory.mktemp("waymo_seq"))
    j_write(root, num_frames=4)
    scenes = {}
    for split in (-1, 2):
        for pkg, default_config, load in (
            ("jax", j_default_config, jds.load_waymo_scene),
            ("torch", t_default_config, lambda c: tds.load_waymo_scene(c, device="cpu")),
        ):
            out = str(tmp_path_factory.mktemp(f"out_{pkg}"))
            np.random.seed(0)
            scenes[pkg, split] = load(_cfg(default_config, root, out, split)), out
    return root, scenes


def test_writer_matches_jax(seq, tmp_path):
    """The port's writer reproduces the JAX writer's sequence: text and
    JSON files byte-equal, npy / npz arrays equal, PNGs decoding to equal
    pixels."""
    root = seq[0]
    mine = str(tmp_path / "seq")
    t_write(mine, num_frames=4)
    n = 0
    for dirpath, _, files in os.walk(root):
        for fn in files:
            a = os.path.join(dirpath, fn)
            b = os.path.join(mine, os.path.relpath(a, root))
            n += 1
            if fn.endswith(".png"):
                np.testing.assert_array_equal(imread(b, unchanged=True), imread(a, unchanged=True), err_msg=fn)
            elif fn.endswith(".npz"):
                x, y = np.load(a, allow_pickle=True), np.load(b, allow_pickle=True)
                assert x.files == y.files
                for k in x.files:
                    dx, dy = x[k].item(), y[k].item()
                    assert dx.keys() == dy.keys()
                    for f in dx:
                        np.testing.assert_array_equal(dy[f], dx[f], err_msg=f"{k}[{f}]")
            elif fn.endswith(".npy"):
                x, y = np.load(a, allow_pickle=True).item(), np.load(b, allow_pickle=True).item()
                for k in x:
                    np.testing.assert_array_equal(y[k], x[k], err_msg=f"{fn}[{k}]")
            else:
                assert filecmp.cmp(a, b, shallow=False), fn
    assert n == sum(len(f) for _, _, f in os.walk(mine)) == 98


def test_dataparser_matches_jax(seq):
    """generate_dataparser_outputs: every field, obj_bounds and the point
    clouds included."""
    root = seq[0]
    want = jwaymo.generate_dataparser_outputs(root, cameras=(0, 1, 2))
    got = twaymo.generate_dataparser_outputs(root, cameras=(0, 1, 2))
    for f in dataclasses.fields(want):
        w, g = getattr(want, f.name), getattr(got, f.name)
        if isinstance(w, dict):
            assert w.keys() == g.keys(), f.name
            for k in w:
                if isinstance(w[k], dict):
                    assert w[k] == g[k], f"{f.name}[{k}]"
                else:
                    np.testing.assert_array_equal(g[k], w[k], err_msg=f"{f.name}[{k}]")
        elif f.name == "obj_bounds":
            assert len(w) == len(g) == 12
            for a, b in zip(w, g):
                np.testing.assert_array_equal(b, a)
        else:
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w), err_msg=f.name)
    assert list(got.obj_info) == [7] and got.points_xyz_dict["bkgd"].shape[0] > 0
    for te, tr in ((4, None), (None, 1), (2, None), (None, 3)):
        assert twaymo.get_val_frames(8, te, tr) == jwaymo.get_val_frames(8, te, tr)


@pytest.mark.parametrize("split", [-1, 2])
def test_load_waymo_scene_matches_jax(seq, split):
    """The packed scene (params, aux, table), the actor pose data, every
    view's camera, ego pose and interp table, the views' metadata and the
    input clouds written under model_path."""
    _, scenes = seq
    (js, jout), (ts, tout) = scenes["jax", split], scenes["torch", split]
    assert_same(js.params_init, ts.params_init, "params")
    assert_same(js.aux_init, ts.aux_init, "aux")
    table_fields = {f.name for f in dataclasses.fields(js.table)}
    for name in table_fields:
        w, g = getattr(js.table, name), getattr(ts.table, name)
        if isinstance(w, (int, float)):
            assert w == pytest.approx(g, rel=1e-6), name
        else:
            assert_same(w, g, f"table.{name}")
    assert ts.table.names == ["background", "obj_007"]
    assert_same(js.pose_data, ts.pose_data, "pose_data")
    assert_same(js.pose_params_init, ts.pose_params_init, "pose_params")
    assert (len(ts.train_views), len(ts.test_views)) == ((12, 0) if split < 0 else (9, 3))
    for jv, tv in zip(js.all_views, ts.all_views):
        for k in ("image_path", "H", "W", "cam", "frame", "frame_idx", "is_val", "image_name",
                  "sky_mask_path", "lidar_depth_path", "sky_scale"):
            assert getattr(jv, k) == getattr(tv, k), k
        assert tv.timestamp == pytest.approx(jv.timestamp, abs=1e-9)
        np.testing.assert_array_equal(tv.obj_bound, jv.obj_bound)
        jf, tf = jv.frame_input, tv.frame_input
        for k in ("w2c", "proj", "cam_center", "K"):
            assert_same(getattr(jf.cam, k), getattr(tf.cam, k), k)
        for k in ("H", "W", "frame", "cam_id", "image_id"):
            assert int(getattr(jf.cam, k)) == getattr(tf.cam, k), k
        assert tf.cam.timestamp == pytest.approx(float(jf.cam.timestamp), abs=1e-6)
        for k in ("ego_quat", "ego_rotmat", "ego_trans"):
            assert_same(getattr(jf, k), getattr(tf, k), k)
        assert_same(jf.interp, tf.interp, "interp")
    for k in ("num_images", "num_cams", "num_frames", "camera_timestamps", "scene_radius", "sphere_radius"):
        assert js.metadata[k] == ts.metadata[k], k
    for k in ("scene_center", "sphere_center"):
        np.testing.assert_array_equal(ts.metadata[k], js.metadata[k])
    plys = sorted(os.listdir(os.path.join(jout, "input_ply")))
    assert plys == sorted(os.listdir(os.path.join(tout, "input_ply")))
    for fn in plys:
        assert filecmp.cmp(os.path.join(jout, "input_ply", fn), os.path.join(tout, "input_ply", fn), shallow=False)


def test_load_ground_truth_matches_jax(seq):
    """Every view's image, sky mask, LiDAR depth, obj_bound and sky scale."""
    _, scenes = seq
    js, ts = scenes["jax", -1][0], scenes["torch", -1][0]
    for jv, tv in zip(js.train_views, ts.train_views):
        want = jds.load_ground_truth(jv)
        got = tds.load_ground_truth(tv, device="cpu")
        assert_same(want, got, f"gt {tv.image_name}")
    assert bool(got.sky_mask.any()) and float(got.lidar_depth.max()) > 0


def test_ground_truth_at_waymo_width_matches_jax(tmp_path):
    """A 1280x1920 sequence (Waymo's FRONT size, the tracked vehicle in
    view) loads at 1600x1067: the area-resized image and the
    nearest-resized guidance (obj_bound included) equal the JAX loader's
    (cv2)."""
    root = str(tmp_path / "seq")
    t_write(root, num_frames=2, cameras=(0,), image_size=(1280, 1920), actor_in_view=True)
    cfgs = [_cfg(d, root, str(tmp_path / n)) for d, n in ((j_default_config, "j"), (t_default_config, "t"))]
    for c in cfgs:
        c.mode, c.data.cameras = "eval", [0]
    jv = jds.load_waymo_scene(cfgs[0]).train_views[1]
    tv = tds.load_waymo_scene(cfgs[1], device="cpu").train_views[1]
    assert (tv.H, tv.W) == (jv.H, jv.W) == (1067, 1600)
    np.testing.assert_array_equal(tv.obj_bound, jv.obj_bound)
    got = tds.load_ground_truth(tv, device="cpu")
    assert_same(jds.load_ground_truth(jv), got, "gt")
    assert bool(got.obj_bound.any())


def test_loaded_view_renders_as_jax(seq):
    """One loaded view (an actor in it) through render_frame, eval mode."""
    _, scenes = seq
    js, ts = scenes["jax", -1][0], scenes["torch", -1][0]
    i = 5
    jparams = jrend.SceneParams(js.params_init, js.pose_params_init, None, None, None)
    jopts = jrend.RenderOptions(mode="eval", tile_capacity=256, instance_capacity=2**15, interpret=True)
    want = jax.jit(lambda p: jrend.render_frame(p, js.aux_init, js.table, js.pose_data,
                                                js.train_views[i].frame_input, step=jnp.asarray(0), opts=jopts))(jparams)
    cfg = t_default_config()
    cfg.render.instance_capacity, cfg.render.tile_capacity = 2**15, 256
    tparams = trunner.build_initial_params(cfg, ts, device="cpu")
    got = trend.render_frame(tparams, ts.aux_init, ts.table, ts.pose_data, ts.train_views[i].frame_input, 0,
                             opts=trunner.render_opts_from_cfg(cfg, "eval"))
    for k in ("rgb", "depth", "acc", "T", "radii"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), err_msg=k, **RENDER)
    for k in ("num_instances", "overflow"):
        assert int(got[k]) == int(want[k]), k
    assert float(got["acc"].max()) > 0.01


def test_native_matches_jax():
    """The port's native library (built into its own directory from the
    same source) gives the JAX package's results, or both fall back."""
    assert (tnative.load_native() is None) == (jnative.load_native() is None)
    rng = np.random.default_rng(1)
    pts = rng.uniform(-5, 5, (20_000, 3)).astype(np.float32)
    rgb = rng.uniform(0, 1, (20_000, 3)).astype(np.float32)
    for a, b in ((tnative.knn_mean_sq_dist3(pts), jnative.knn_mean_sq_dist3(pts)),
                 (tnative.radius_outlier_counts(pts, 0.3), jnative.radius_outlier_counts(pts, 0.3)),
                 *zip(tnative.voxel_downsample(pts, rgb, 0.5) or (None, None),
                      jnative.voxel_downsample(pts, rgb, 0.5) or (None, None))):
        if b is None:
            assert a is None
        else:
            np.testing.assert_array_equal(a, b)
    if tnative.load_native() is not None:
        assert os.path.dirname(tnative._LIB._name).endswith(os.path.join("street_gaussians_torch", "_build", "native"))
