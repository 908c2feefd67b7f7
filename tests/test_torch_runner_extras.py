"""The runner's last pieces against the JAX package's: the log_images grid
(runner.log_image_grid against the grid runner.training builds inline,
street_gaussians_tpu/runner.py:971-1003; runner.training writing it),
make_ply (the port's
`python -m street_gaussians_torch.make_ply` against the root make_ply.py)
and utils/semantics.py.

The grid and the PLY use the initial model of the runner tests' toy
sequence (tests/test_torch_runner.py: 3 frames of camera 0 at 64x96, the
tracked vehicle in view, no sky), built by both packages as training
builds it (mode train; JAX's make_ply is handed that scene, as the
runner tests hand JAX's render_sets the training-time scene); numpy's
global generator is seeded before each build (the vehicle's grid
colours).

Tolerances, and why:
* the grid: every panel but the depth colour map within GRID_ATOL (the
  renders agree to 1e-5, tests/test_torch_render.py) but at most
  GRID_FLIP_FRACTION of the pixels, each within one 8-bit level (the
  render_sets tests' PNG tolerance): where the two packages' f32 sums
  round a Gaussian across the blend's 1/255 alpha edge, its pixel moves
  by its contribution (measured: one pixel of 6,144, rgb 1.0e-3, depth
  2.3e-3, acc 1.7e-6); the depth colour map is a 2-98 percentile
  normalisation of each package's own depth, quantised to 256 levels,
  so a pixel on a level's edge may take the next level: at most
  DEPTH_FLIP_FRACTION of its pixels differ, each by at most one step of
  the jet table;
* the PLY: the same header (element, fields, row count) and row order;
  every float column within PLY_ATOL (compose's f32 transforms of the
  actor rows; measured: within 2.4e-7);
* semantics: the colour maps equal; vq's indices equal (random inputs,
  no near ties); the straight-through gradients within 1e-6 (sums of
  the same rows; measured: equal).
"""

import copy
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import make_ply as j_make_ply
from street_gaussians_torch import checkpoint as tckpt
from street_gaussians_torch import make_ply as t_make_ply
from street_gaussians_torch import runner as trunner
from street_gaussians_torch.config import load_config as t_load_config
from street_gaussians_torch.data.dataset import load_ground_truth as t_load_ground_truth
from street_gaussians_torch.models.renderer import render_object_mask as t_object_mask
from street_gaussians_torch.utils import semantics as tsem
from street_gaussians_torch.utils.image_io import imread
from street_gaussians_torch.utils.ply import read_ply
from street_gaussians_torch.visualize import COLORMAPS
from street_gaussians_tpu import runner as jrunner
from street_gaussians_tpu import train_lib as jtrain
from street_gaussians_tpu.config import load_config as j_load_config
from street_gaussians_tpu.data.dataset import load_ground_truth as j_load_ground_truth
from street_gaussians_tpu.models.renderer import render_object_mask as j_object_mask
from street_gaussians_tpu.utils import semantics as jsem
from street_gaussians_tpu.visualize import visualize_depth as j_visualize_depth
from test_torch_runner import draw_free_overrides, one_thread, small_sensors, write_sequence  # noqa: F401

GRID_ATOL = 1e-5
GRID_FLIP_FRACTION = 1e-3
DEPTH_FLIP_FRACTION = 0.01
PLY_ATOL = 1e-5
VQ_ATOL = 1e-6


def jax_grid(gt_image, r, ro):
    """street_gaussians_tpu/runner.py:977-996, as the JAX runner builds it."""
    rgb = np.asarray(r["rgb"])
    depth_c, _ = j_visualize_depth(np.asarray(r["depth"]))
    acc = np.asarray(r["acc"])[..., None].repeat(3, -1)
    if ro is not None:
        obj_rgb = np.asarray(ro["rgb"])
        obj_acc = np.asarray(ro["acc"])[..., None].repeat(3, -1)
    else:
        obj_rgb = np.zeros_like(rgb)
        obj_acc = np.zeros_like(rgb)
    row0 = np.concatenate([np.asarray(gt_image), rgb, depth_c / 255.0], axis=1)
    row1 = np.concatenate([acc, obj_rgb, obj_acc], axis=1)
    return np.clip(np.concatenate([row0, row1], axis=0), 0, 1)


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("extras")
    root = str(tmp / "seq")
    write_sequence(root)
    return tmp, root


@pytest.mark.parametrize("with_objects", [True, False])
def test_log_image_grid_matches_jax(toy, with_objects):
    tmp, root = toy
    over = draw_free_overrides(root, str(tmp / "grid"))
    jcfg, tcfg = j_load_config(None, over), t_load_config(None, over)
    np.random.seed(0)
    jscene = jrunner.build_scene(jcfg)
    jstate = jtrain.init_train_state(jrunner.build_initial_params(jcfg, jscene), jscene.aux_init)
    np.random.seed(0)
    tscene = trunner.build_scene(tcfg, device="cpu")
    tstate = trunner.init_train_state(trunner.build_initial_params(tcfg, tscene, device="cpu"), tscene.aux_init)
    jview, tview = jscene.train_views[-1], tscene.train_views[-1]
    assert jview.image_name == tview.image_name

    jr = jrunner.make_eval_render(jcfg, jscene)(jstate.params, jstate.aux, jview.frame_input)
    tr = trunner.make_eval_render(tcfg, tscene)(tstate.params, tstate.aux, tview.frame_input)
    jro = tro = None
    if with_objects:
        jro = jrunner.make_eval_render(jcfg, jscene, j_object_mask(jscene.table))(
            jstate.params, jstate.aux, jview.frame_input)
        tro = trunner.make_eval_render(tcfg, tscene, t_object_mask(tscene.table))(
            tstate.params, tstate.aux, tview.frame_input)
        assert float(tro["acc"].max()) > 0.1  # the vehicle is in view
    want = jax_grid(j_load_ground_truth(jview).image, jr, jro)
    got = trunner.log_image_grid(t_load_ground_truth(tview, device="cpu").image, tr, tro)
    H, W = 64, 96
    assert got.shape == want.shape == (2 * H, 3 * W, 3) and got.dtype == want.dtype
    depth = np.zeros(got.shape[:2], bool)
    depth[:H, 2 * W:] = True
    d = np.abs(got[~depth] - want[~depth]).max(axis=-1)
    assert (d > GRID_ATOL).mean() <= GRID_FLIP_FRACTION and d.max() <= 1.0 / 255.0, d.max()
    d = np.abs(got[depth] - want[depth]).max(axis=-1)
    step = np.abs(np.diff(COLORMAPS["jet"].astype(np.float64), axis=0)).max() / 255.0
    assert (d > GRID_ATOL).mean() <= DEPTH_FLIP_FRACTION and d.max() <= step + GRID_ATOL


def test_training_writes_log_images(toy):
    """runner.training writes the grid at iteration 1,000 as a PNG: a
    run resumed from a checkpoint of the initial state at 995."""
    tmp, root = toy
    out = str(tmp / "log_run")
    cfg = t_load_config(None, draw_free_overrides(root, out, iterations=1000))
    np.random.seed(0)
    scene = trunner.build_scene(cfg, device="cpu")
    state = trunner.init_train_state(trunner.build_initial_params(cfg, scene, device="cpu"), scene.aux_init)
    tckpt.save_train_state(cfg.trained_model_dir, 995, state)
    np.random.seed(0)
    final = trunner.training(cfg, progress=False, device="cpu")
    assert final["start_iteration"] == 995 and final["timing"]["log_images_s"] > 0
    assert os.listdir(os.path.join(out, "log_images")) == ["1000.png"]
    grid = imread(os.path.join(out, "log_images", "1000.png"))
    assert grid.shape == (2 * 64, 3 * 96, 3) and grid[64:, 96:].max() > 0  # the vehicle's render


def _header(path):
    with open(path, "rb") as f:
        data = f.read()
    return data[: data.index(b"end_header\n")]


def test_make_ply_matches_jax(toy, monkeypatch):
    """Both CLIs on the toy sequence's initial model (no checkpoint):
    the composite at viewer.frame_id 1 as one vertex element."""
    tmp, root = toy
    over = [*draw_free_overrides(root, str(tmp / "ply_jax")), "viewer.frame_id", "1"]
    train_scene = jrunner.build_scene

    def scene_as_trained(cfg):
        c = copy.deepcopy(cfg)
        c.mode = "train"
        return train_scene(c)

    monkeypatch.setattr(jrunner, "build_scene", scene_as_trained)
    monkeypatch.setattr(sys, "argv", ["make_ply.py", *over])
    np.random.seed(0)
    j_make_ply.main()
    want_path = os.path.join(str(tmp / "ply_jax"), "viewer", "000001", "point_cloud", "iteration_40",
                             "point_cloud.ply")
    np.random.seed(0)
    got_path = t_make_ply.main(["--device", "cpu", *[v.replace("ply_jax", "ply_port") for v in over]])
    assert got_path == want_path.replace("ply_jax", "ply_port")
    assert _header(got_path) == _header(want_path)
    got, want = read_ply(got_path)["vertex"], read_ply(want_path)["vertex"]
    assert got.dtype == want.dtype and len(got) == len(want) > 1000
    for name in want.dtype.names:
        np.testing.assert_allclose(got[name], want[name], rtol=0, atol=PLY_ATOL, err_msg=name)


@pytest.mark.parametrize("case", ["colormap", "vis_label", "vis_gt", "vq"])
def test_semantics_match_jax(case):
    rng = np.random.default_rng(3)
    if case == "colormap":
        for n in (1, 21, 256):
            np.testing.assert_array_equal(tsem.label_colormap(n), jsem.label_colormap(n))
    elif case == "vis_label":
        sem = rng.normal(size=(16, 24, 20)).astype(np.float32)
        np.testing.assert_array_equal(tsem.vis_semantic_label(sem), jsem.vis_semantic_label(sem))
        cmap = tsem.label_colormap(64)
        np.testing.assert_array_equal(tsem.vis_semantic_label(sem, cmap), jsem.vis_semantic_label(sem, cmap))
    elif case == "vis_gt":
        gt = rng.integers(-1, 19, size=(16, 24))
        np.testing.assert_array_equal(tsem.vis_semantic_gt(gt), jsem.vis_semantic_gt(gt))
    else:
        x = rng.normal(size=(6, 7, 4)).astype(np.float32)
        cb = rng.normal(size=(9, 4)).astype(np.float32)
        w = rng.normal(size=(6, 7, 4)).astype(np.float32)
        np.testing.assert_array_equal(tsem.vq(torch.as_tensor(x), torch.as_tensor(cb)).numpy(),
                                      np.asarray(jsem.vq(jnp.asarray(x), jnp.asarray(cb))))

        def jloss(xx, cc):
            codes, _ = jsem.vq_straight_through(xx, cc)
            return jnp.sum(codes * w)

        jgx, jgc = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(cb))
        tx = torch.as_tensor(x).requires_grad_(True)
        tc = torch.as_tensor(cb).requires_grad_(True)
        codes, idx = tsem.vq_straight_through(tx, tc)
        np.testing.assert_array_equal(codes.detach().numpy(), cb[idx.numpy()])
        gx, gc = torch.autograd.grad((codes * torch.as_tensor(w)).sum(), (tx, tc))
        np.testing.assert_allclose(gx.numpy(), np.asarray(jgx), rtol=0, atol=VQ_ATOL)
        np.testing.assert_allclose(gc.numpy(), np.asarray(jgc), rtol=0, atol=VQ_ATOL)
        assert np.abs(gc.numpy()).sum() > 0
