"""The port's visualize.py and runner.render_trajectory against the JAX
package's, and `python -m street_gaussians_torch.render --mode
trajectory`.

The state is one scene's initial weights (the scene as training builds
it, on a miniature 3-frame, 2-camera sequence of data/synthetic_waymo.py
at 64x96) with a random 32-texel sky, in both packages; the eval renders
draw nothing. render.concat_cameras [1] keeps the second camera and the
sky is sampled on a 1/4 ray grid (render.sky_downsample 4).

Tolerances: the colour maps and visualize_depth / visualize_diff on the
same inputs equal cv2's and JAX's exactly; the rgb, object, background
and acc PNGs within 1 per channel (uint8 rounding of renders that agree
to 1e-5, tests/test_torch_render.py); a depth PNG pixel within one step
of the JET table (a depth that rounds to the next of 256 levels); the
same file names in both.
"""

import dataclasses
import importlib.util
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest

from street_gaussians_torch import checkpoint as tckpt
from street_gaussians_torch import render as trender_cli
from street_gaussians_torch import runner as trunner
from street_gaussians_torch import visualize as tvis
from street_gaussians_torch.config import load_config as t_load_config
from street_gaussians_torch.data.synthetic_waymo import write_synthetic_waymo
from street_gaussians_torch.utils.image_io import imread
from street_gaussians_tpu import runner as jrunner
from street_gaussians_tpu import train_lib as jtrain
from street_gaussians_tpu.config import load_config as j_load_config
from street_gaussians_tpu.models.sky_cubemap import SkyParams as JSkyParams
from test_torch_runner import draw_free_overrides, one_thread, small_sensors  # noqa: F401
from test_torch_train import port_state

CHANNELS = ("rgb", "object", "background", "depth", "acc")


NO_CV2 = "OpenCV (cv2) is not installed: the colour maps cannot be held against cv2.applyColorMap"


@pytest.mark.parametrize("name", ["jet", "turbo"])
def test_colormaps_equal_cv2(name):
    """The numpy tables equal cv2.applyColorMap on all 256 inputs."""
    cv2 = pytest.importorskip("cv2", reason=NO_CV2)
    x = np.arange(256, dtype=np.uint8)
    want = cv2.applyColorMap(x[:, None], getattr(cv2, f"COLORMAP_{name.upper()}"))[:, 0, ::-1]
    np.testing.assert_array_equal(tvis.apply_colormap(x, name), want)
    np.testing.assert_array_equal(tvis.COLORMAPS[name], want)


def test_visualize_depth_and_diff_match_jax():
    """visualize_depth (2-98 percentile of the valid depths, NaN and 0
    ignored; a given minmax; an all-zero depth) and visualize_diff, equal
    to the JAX package's (cv2) functions."""
    pytest.importorskip("cv2", reason=NO_CV2)
    from street_gaussians_tpu import visualize as jvis

    rng = np.random.default_rng(0)
    depth = rng.uniform(1, 40, (37, 53)).astype(np.float32)
    depth[rng.uniform(size=depth.shape) < 0.2] = 0.0
    depth[3, 4] = np.nan
    for kw in ({}, {"minmax": (5.0, 20.0)}):
        got, gmm = tvis.visualize_depth(depth, **kw)
        want, wmm = jvis.visualize_depth(depth, **kw)
        np.testing.assert_array_equal(got, want)
        assert gmm == wmm
    np.testing.assert_array_equal(tvis.visualize_depth(np.zeros((4, 5)))[0], jvis.visualize_depth(np.zeros((4, 5)))[0])
    pred, gt = rng.uniform(0, 1, (2, 37, 53, 3)).astype(np.float32)
    np.testing.assert_array_equal(tvis.visualize_diff(pred, gt), jvis.visualize_diff(pred, gt))
    img = rng.uniform(-0.2, 1.2, (5, 6, 3)).astype(np.float32)
    np.testing.assert_array_equal(tvis.to_u8(img), jvis.to_u8(img))


def test_write_video_needs_opencv(tmp_path, monkeypatch):
    """Without OpenCV write_video raises (it never skips quietly); an empty
    frame list writes nothing."""
    monkeypatch.setitem(sys.modules, "cv2", None)
    frame = np.zeros((8, 8, 3), np.uint8)
    with pytest.raises(RuntimeError, match="save_video false"):
        tvis.write_video(str(tmp_path / "a.mp4"), [frame])
    tvis.write_video(str(tmp_path / "b.mp4"), [])
    assert not os.listdir(tmp_path)


def overrides(root, model_path):
    return [*draw_free_overrides(root, model_path, 10), "data.cameras", "[0, 1]", "model.nsg.include_sky", "true",
            "model.sky.resolution", "32", "render.concat_cameras", "[1]", "render.sky_downsample", "4",
            "train.checkpoint_iterations", "[10]"]


@pytest.fixture(scope="module")
def trajectories(tmp_path_factory):
    """Both packages' render_trajectory of one state (save_video on: the
    videos through cv2 where it is installed)."""
    tmp = tmp_path_factory.mktemp("trajectory")
    root = str(tmp / "seq")
    write_synthetic_waymo(root, num_frames=3, cameras=(0, 1), actor_in_view=True)
    jcfg = j_load_config(None, overrides(root, str(tmp / "jax")))
    tcfg = t_load_config(None, overrides(root, str(tmp / "port")))
    tcfg.render.save_video = jcfg.render.save_video = importlib.util.find_spec("cv2") is not None
    np.random.seed(0)
    jscene = jrunner.build_scene(jcfg)  # mode "train": the clouds loaded, as training builds it
    params = jrunner.build_initial_params(jcfg, jscene)
    cubemap = np.random.default_rng(5).uniform(0.1, 0.9, np.asarray(params.sky.cubemap).shape).astype(np.float32)
    params = dataclasses.replace(params, sky=JSkyParams(cubemap=jnp.asarray(cubemap)))
    js = jtrain.init_train_state(params, jscene.aux_init)
    jcfg.mode = tcfg.mode = "evaluate"
    jout = jrunner.render_trajectory(jcfg, state=js, scene=jscene)
    ts = port_state(js)
    np.random.seed(0)
    tout = trunner.render_trajectory(tcfg, state=ts, scene=trunner.build_trained_scene(tcfg, device="cpu"),
                                     device="cpu")
    return dict(tmp=tmp, root=root, jout=jout, tout=tout, tcfg=tcfg, ts=ts)


def test_render_trajectory_matches_jax(trajectories):
    """The same files (camera 1's three frames, five channels, and the
    videos where OpenCV is installed); the PNGs within the stated
    tolerances."""
    jdir, tdir = trajectories["jout"]["out_dir"], trajectories["tout"]["out_dir"]
    assert trajectories["tout"]["num_frames"] == trajectories["jout"]["num_frames"] == 3
    want_files, got_files = sorted(os.listdir(jdir)), sorted(os.listdir(tdir))
    assert got_files == want_files
    pngs = [f for f in got_files if f.endswith(".png")]
    assert pngs == sorted(f"00000{i}_1_{c}.png" for i in range(3) for c in CHANNELS)
    if trajectories["tcfg"].render.save_video:
        assert [f for f in got_files if f.endswith(".mp4")] == sorted(f"{c}.mp4" for c in CHANNELS)
    jet = tvis.COLORMAPS["jet"].astype(int)
    jet_step = int(np.abs(np.diff(jet, axis=0)).max())
    for f in pngs:
        got, want = imread(os.path.join(tdir, f)).astype(int), imread(os.path.join(jdir, f)).astype(int)
        assert got.shape == want.shape == (64, 96, 3), f
        d = np.abs(got - want).max()
        assert d <= (jet_step if f.endswith("_depth.png") else 1), (f, d)
    rgb = imread(os.path.join(tdir, "000001_1_rgb.png"))
    obj = imread(os.path.join(tdir, "000001_1_object.png"))
    assert rgb.std() > 0 and obj.max() > 0 and (obj < rgb.max()).any()


def test_render_cli_trajectory(trajectories):
    """python -m street_gaussians_torch.render --mode trajectory on the
    port's own checkpoint of the same state: the PNGs of the direct call,
    bit for bit."""
    tcfg = trajectories["tcfg"]
    model_path = str(trajectories["tmp"] / "cli")
    tckpt.save_train_state(os.path.join(model_path, "trained_model"), 10, trajectories["ts"])
    argv = ["--mode", "trajectory", "--device", "cpu", *overrides(trajectories["root"], model_path),
            "render.save_video", "false"]
    out = trender_cli.main(argv)
    assert out["num_frames"] == 3
    files = sorted(os.listdir(out["out_dir"]))
    assert files == sorted(f for f in os.listdir(trajectories["tout"]["out_dir"]) if f.endswith(".png"))
    for f in files:
        np.testing.assert_array_equal(imread(os.path.join(out["out_dir"], f)),
                                      imread(os.path.join(trajectories["tout"]["out_dir"], f)), err_msg=f)
    assert tcfg.render.sky_downsample == 4
