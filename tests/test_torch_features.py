"""Semantic and normal renders in the port, the sky sampled on a 1/N ray
grid for N above 2, and the semantic rows through a train step, densify
and the PLY, against the JAX package (Pallas in interpret mode).

The renders blend F = 4 + 3 (normals) + S (semantic classes) features:
F = 7, 9, 24 and 27 here, past the 8 of the kernels' instantiated
counts (on the CPU the blend takes its plain versions, which take any
F up to the kernels' cap; tests/test_torch_cuda.py holds the kernels
against them on the card).

Tolerances, and why:
* compose (semantics, normals): rtol = atol = 1e-6: the same f32
  operations on the same rows.
* renders: rtol = atol = 1e-5, as tests/test_torch_render.py (f32 sums
  in another order); the log-probabilities of "probabilities" mode the
  same, since log(x + 1e-8) turns a relative error of x into an absolute
  one no larger; integer counters equal.
* the table layout against the instance layout, outputs: rtol = atol =
  1e-5 (log-space against direct-product transmittance); gradients each
  divided by the leaf's largest value, atol 1e-5.
* the bilinear sky upsample against jax.image.resize: atol 1e-6 (weights
  applied in another order); the edge rows and columns of an image grown
  by N take the edge pixel alone, exactly, in both.
* the train step: scalars rtol 1e-5, gradients and parameters as
  tests/test_torch_train.py (chip_smoke.grads_close and params_close);
  the semantic rows' gradients are exactly 0 and their values unchanged,
  in both packages.
* densify: as tests/test_torch_train.py (1e-6); the PLY byte-equal.
"""

import copy
import dataclasses
import filecmp
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import grads_close, params_close
from street_gaussians_torch import checkpoint as tckpt
from street_gaussians_torch import convert
from street_gaussians_torch import train_lib as ttrain
from street_gaussians_torch.config import default_config as t_default_config
from street_gaussians_torch.models import renderer as trend
from street_gaussians_torch.models.sky_cubemap import build_sky_table
from street_gaussians_torch.ops import rasterize as trast
from street_gaussians_torch.optim.densify import DensifyNoise
from street_gaussians_torch.runner import render_opts_from_cfg
from street_gaussians_tpu import checkpoint as jckpt
from street_gaussians_tpu import train_lib as jtrain
from street_gaussians_tpu.config import default_config
from street_gaussians_tpu.data.synthetic import make_synthetic_scene
from street_gaussians_tpu.models import renderer as jrend
from test_torch_render import port_opts, sky_scene  # noqa: F401 (a fixture)
from test_torch_train import jax_flat, numpy_tree, port_state

TOL = dict(rtol=1e-5, atol=1e-5)
COMPOSE_TOL = dict(rtol=1e-6, atol=1e-6)
H, W = 32, 48
CAP = 2**14


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for the port's tiny tensors (see
    tests/test_torch_runner.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def semantic_scene(num_classes, mode="logits", seed=0):
    """32x48, one actor of class num_classes - 2, random semantic values
    (non-negative in "probabilities" mode, whose log needs them), random
    rotations and anisotropic scales (so that the min-scale axis is not a
    tie)."""
    scene = make_synthetic_scene(num_bkgd=200, num_actors=1, H=H, W=W, seed=seed,
                                 use_semantic=num_classes > 0, num_classes=max(num_classes, 1))
    rng = np.random.default_rng(seed + 1)
    g = scene.params_init
    C = scene.table.capacity
    alive = np.asarray(scene.aux.alive)[:, None]
    shape = np.asarray(g.semantic).shape
    sem = rng.uniform(0.05, 1.0, shape) if mode == "probabilities" else rng.normal(size=shape)
    rot = np.where(alive, rng.normal(size=(C, 4)), np.asarray(g.rot))
    log_scale = np.asarray(g.log_scale) + rng.uniform(-0.4, 0.4, (C, 3)) * alive
    g = dataclasses.replace(g, semantic=jnp.asarray(sem, jnp.float32), rot=jnp.asarray(rot, jnp.float32),
                            log_scale=jnp.asarray(log_scale, jnp.float32))
    labels = np.asarray(scene.table.class_label).copy()
    labels[1:] = max(num_classes - 2, 0)
    table = dataclasses.replace(scene.table, class_label=jnp.asarray(labels, jnp.int32))
    params = jrend.SceneParams(g, scene.pose_params_init, None, None, None)
    return scene, table, params


def carry(scene, table, params, frame):
    p, aux, ttable, pose = convert.scene_from_numpy(
        numpy_tree(params), numpy_tree(scene.aux), numpy_tree(table), numpy_tree(scene.pose_data), "cpu")
    return p, aux, ttable, pose, convert.frame_from_numpy(numpy_tree(frame), "cpu")


def jax_opts(**kw):
    return jrend.RenderOptions(mode="eval", tile_capacity=128, instance_capacity=CAP, interpret=True, **kw)


# ---------------------------------------------------------------- compose


@pytest.mark.parametrize("mode", ["logits", "probabilities"])
def test_compose_semantics_and_normals_match_jax(mode):
    """compose_frame's semantic columns (the background's own, the actor's
    one channel in its class column, through a sigmoid under
    "probabilities") and camera-facing normals; the scene's S = 20
    columns and class labels come across convert whole; a scene packed
    without semantics pads its one column with zeros."""
    scene, table, params = semantic_scene(20, mode)
    p, aux, ttable, pose, f = carry(scene, table, params, scene.frames[3])
    assert tuple(p.gaussians.semantic.shape) == (table.capacity, 20)
    np.testing.assert_array_equal(p.gaussians.semantic.numpy(), np.asarray(params.gaussians.semantic))
    np.testing.assert_array_equal(ttable.class_label.numpy(), np.asarray(table.class_label))
    assert ttable.num_classes == 20 and int(ttable.class_label[1]) == 18
    jopts = jax_opts(use_semantic=True, render_normal=True, semantic_mode=mode)
    want = jrend.compose_frame(params, scene.aux, table, scene.pose_data, scene.frames[3],
                               step=jnp.asarray(0), opts=jopts)
    got = trend.compose_frame(p, aux, ttable, pose, f, 0, opts=port_opts(jopts))
    for k in ("semantic", "normals", "means3d", "quats", "scales"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), err_msg=k, **COMPOSE_TOL)
    s, e = (int(v) for v in table.slices[1])
    sem = got["semantic"].numpy()
    assert (sem[s:e, :18] == 0).all() and (sem[s:e, 19] == 0).all() and (sem[s:e, 18] != 0).any()
    np.testing.assert_allclose(np.linalg.norm(got["normals"].numpy(), axis=-1), 1.0, atol=1e-5)

    # packed without semantics: one column, padded to num_classes
    scene1, table1, params1 = semantic_scene(0, mode)
    table1 = dataclasses.replace(table1, num_classes=6)
    p1, aux1, ttable1, pose1, f1 = carry(scene1, table1, params1, scene1.frames[3])
    want1 = jrend.compose_frame(params1, scene1.aux, table1, scene1.pose_data, scene1.frames[3],
                                step=jnp.asarray(0), opts=jax_opts(use_semantic=True, semantic_mode=mode))
    got1 = trend.compose_frame(p1, aux1, ttable1, pose1, f1, 0,
                               opts=trend.RenderOptions(mode="eval", use_semantic=True, semantic_mode=mode))
    assert tuple(got1["semantic"].shape) == (table1.capacity, 6) and got1["normals"] is None
    np.testing.assert_allclose(got1["semantic"].numpy(), np.asarray(want1["semantic"]), **COMPOSE_TOL)


# ---------------------------------------------------------------- renders


@pytest.mark.parametrize("classes,normal,mode", [
    (0, True, "logits"),  # F = 7
    (5, False, "logits"),  # F = 9
    (5, False, "probabilities"),
    (20, False, "logits"),  # F = 24
    (20, False, "probabilities"),
    (20, True, "logits"),  # F = 27
    (20, True, "probabilities"),
])
def test_semantic_and_normal_renders_match_jax(classes, normal, mode):
    """render_frame with normals and/or semantics (F = 7, 9, 24, 27) in
    both semantic modes, eval mode at 32x48 (tests/test_features.py's
    scene)."""
    scene, table, params = semantic_scene(classes, mode)
    frame = scene.frames[2]
    jopts = jax_opts(use_semantic=classes > 0, render_normal=normal, semantic_mode=mode)
    want = jrend.render_frame(params, scene.aux, table, scene.pose_data, frame, step=jnp.asarray(0), opts=jopts)
    p, aux, ttable, pose, f = carry(scene, table, params, frame)
    got = trend.render_frame(p, aux, ttable, pose, f, 0, opts=port_opts(jopts))
    keys = ["rgb", "depth", "acc", "T", "radii"] + (["normals"] if normal else []) + (["semantic"] if classes else [])
    for k in keys:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), err_msg=k, **TOL)
    for k in ("num_instances", "overflow"):
        assert int(got[k]) == int(want[k]), k
    assert "extra" not in got
    if classes:
        assert tuple(got["semantic"].shape) == (H, W, classes)
    if normal:
        n = np.linalg.norm(got["normals"].numpy(), axis=-1)
        assert np.allclose(n[got["acc"].numpy() > 0.5], 1.0, atol=1e-3)
    assert int(want["num_instances"]) > 0


def test_table_layout_matches_instance_layout_at_27_features():
    """The dense-table layout (kernels 2.5, 2.6) against the instance
    layout (2.1, 2.2) at F = 27, forward and gradients of every screen
    leaf and of the extra channels, on the CPU."""
    scene, table, params = semantic_scene(20)
    p, aux, ttable, pose, f = carry(scene, table, params, scene.frames[2])
    opts = trend.RenderOptions(mode="eval", use_semantic=True, render_normal=True, tile_capacity=256,
                               instance_capacity=CAP)
    screen, composed = trend.screen_space(p, aux, ttable, pose, f, 0, opts=opts)
    extras = torch.cat([composed["normals"], composed["semantic"]], dim=-1).detach()
    assert extras.shape[1] == 23
    results = {}
    for layout in ("instance", "table"):
        leaves = {k: getattr(screen, k).detach().clone().requires_grad_(True)
                  for k in ("mean2d", "conic", "opacity", "rgb", "depth")}
        ex = extras.clone().requires_grad_(True)
        scr = screen._replace(**leaves)
        cfg = trast.RasterizeConfig(tile_capacity=256, instance_capacity=CAP, layout=layout)
        out = trast.rasterize(scr, H, W, torch.zeros(3), extra_features=ex, config=cfg)
        w = torch.as_tensor(np.random.default_rng(5).normal(size=(H, W, 23)).astype(np.float32))
        loss = (out["extra"] * w).sum() + out["rgb"].sum() + out["depth"].sum()
        grads = torch.autograd.grad(loss, [*leaves.values(), ex])
        results[layout] = (out, dict(zip([*leaves, "extra"], grads)))
    (oi, gi), (ot, gt) = results["instance"], results["table"]
    for k in ("rgb", "depth", "acc", "T", "extra"):
        np.testing.assert_allclose(ot[k].detach().numpy(), oi[k].detach().numpy(), err_msg=k, **TOL)
    for k, v in gi.items():
        scale = max(float(v.abs().max()), 1e-30)
        np.testing.assert_allclose(gt[k].numpy() / scale, v.numpy() / scale, rtol=0, atol=1e-5, err_msg=k)
    assert int(oi["overflow"]) == 0 and int(ot["overflow"]) == 0


# ---------------------------------------------------------------- sky_downsample > 2


@pytest.mark.parametrize("ds", [3, 4, 5])
def test_bilinear_upsample_matches_jax_resize(ds):
    """The sky's upsample by N > 2 against jax.image.resize(method=
    "bilinear"), including the edges: the first and last rows and
    columns of the grown image take their edge pixel alone (JAX
    renormalises the triangle weights, torch clamps the position)."""
    rng = np.random.default_rng(ds)
    img = rng.uniform(0, 1, (5, 7, 3)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(img), (5 * ds, 7 * ds, 3), method="bilinear"))
    got = trend._upsample_bilinear(torch.as_tensor(img), ds).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    # the outer ds // 2 rows/columns lie beyond the edge pixels' centres
    e = ds // 2
    for a in (got, want):
        np.testing.assert_allclose(a[:e, :e], np.broadcast_to(img[0, 0], (e, e, 3)), rtol=0, atol=1e-7)
        np.testing.assert_allclose(a[-e:, -e:], np.broadcast_to(img[-1, -1], (e, e, 3)), rtol=0, atol=1e-7)


@pytest.mark.parametrize("ds", [3, 4])
def test_sky_downsample_matches_jax(sky_scene, ds):
    """An eval render with the sky on a 1/3 and a 1/4 ray grid (64x96 is a
    multiple of neither 3 nor, in tiles, of 4 x 16), with and without the
    prebuilt sky table (the same bits), against JAX; train mode ignores
    sky_downsample."""
    scene, params = sky_scene
    frame = scene.frames[5]
    jopts = jrend.RenderOptions(mode="eval", tile_capacity=256, instance_capacity=CAP, interpret=True,
                                sky_downsample=ds)
    want = jrend.render_frame(params, scene.aux, scene.table, scene.pose_data, frame,
                              step=jnp.asarray(10**9), opts=jopts)
    p, aux, table, pose, f = carry(scene, scene.table, params, frame)
    opts = port_opts(jopts)
    got = trend.render_frame(p, aux, table, pose, f, 10**9, opts=opts)
    for k in ("rgb", "depth", "acc", "T"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), err_msg=k, **TOL)
    with_table = trend.render_frame(p, aux, table, pose, f, 10**9, opts=opts,
                                    sky_table=build_sky_table(p.sky.cubemap))
    assert torch.equal(with_table["rgb"], got["rgb"])
    full = trend.render_frame(p, aux, table, pose, f, 10**9, opts=dataclasses.replace(opts, sky_downsample=1))
    assert float((full["rgb"] - got["rgb"]).abs().max()) > 0  # the grid is coarser
    assert float(np.asarray(want["T"]).max()) > 0.5  # the sky shows
    # train mode: the full-resolution sky, whatever sky_downsample says
    jitter = torch.as_tensor(np.random.default_rng(7).uniform(-0.5, 0.5, (64, 96, 2)).astype(np.float32))
    train = [trend.render_frame(p, aux, table, pose, f, 10**9, sky_jitter=jitter,
                                opts=dataclasses.replace(opts, mode="train", sky_downsample=d))["rgb"]
             for d in (1, ds)]
    assert torch.equal(train[0], train[1])


# ---------------------------------------------------------------- training


@pytest.fixture(scope="module")
def sem_step():
    """One JAX train step (Pallas in interpret mode) with semantics at
    20 classes and normals (F = 27) on the 32x48 scene, its draws for
    the port, and one JAX densify round of the stepped state with low
    thresholds (rows clone and split) and its draws."""
    scene, table, params = semantic_scene(20)
    M = table.num_models
    table = dataclasses.replace(table, flip_prob=jnp.asarray([0.0] + [0.5] * (M - 1), jnp.float32))
    frame = scene.frames[2]
    jopts = jrend.RenderOptions(mode="train", tile_capacity=CAP, instance_capacity=CAP, interpret=True,
                                use_semantic=True, render_normal=True)
    rng = np.random.default_rng(8)
    img = np.asarray(jrend.render_frame(params, scene.aux, table, scene.pose_data, frame, step=jnp.asarray(2500),
                                        opts=dataclasses.replace(jopts, mode="eval"))["rgb"])
    img = np.clip(img + rng.normal(0, 0.05, img.shape), 0, 1).astype(np.float32)
    gt = jtrain.GroundTruth(
        image=jnp.asarray(img), mask=jnp.ones((H, W, 1), bool), sky_mask=jnp.zeros((H, W, 1), bool),
        lidar_depth=jnp.full((H, W), 8.0, jnp.float32), obj_bound=jnp.zeros((H, W, 1), bool),
        sky_scale=jnp.ones(()),
    )
    cfg = default_config()
    cfg.optim.lambda_depth_lidar = 0.1
    cfg.data.use_semantic = True
    cfg.render.render_normal = True
    state0 = dataclasses.replace(jtrain.init_train_state(params, scene.aux), step=jnp.asarray(2500, jnp.int32))
    key = jax.random.PRNGKey(3)
    k_render, _ = jax.random.split(key)
    flip = np.asarray(jax.random.uniform(k_render, (table.capacity,))) < np.asarray(
        table.flip_prob)[np.asarray(scene.aux.model_id)]
    state1, scalars = jtrain.make_train_step(cfg, table, scene.pose_data, jopts, donate=False)(
        copy.deepcopy(state0), frame, gt, key)

    dcfg = copy.deepcopy(cfg)
    st = state1
    alive = np.asarray(st.aux.alive)
    grads = np.asarray(st.aux.grad_accum)[:, 0] / np.maximum(np.asarray(st.aux.denom), 1)
    dcfg.optim.densify_grad_threshold = float(np.quantile(grads[alive], 0.7))
    ratio = np.exp(np.asarray(st.params.gaussians.log_scale)).max(axis=1) / np.asarray(
        table.extent)[np.asarray(st.aux.model_id)]
    dcfg.optim.percent_dense = float(np.median(ratio[alive & (grads >= dcfg.optim.densify_grad_threshold)]))
    C = table.capacity
    dkey = jax.random.PRNGKey(21)
    k1, k_box = jax.random.split(dkey)
    _, k_s1, k_s2 = jax.random.split(k1, 3)
    noise = DensifyNoise(*(torch.as_tensor(np.array(jax.random.normal(k, shape))) for k, shape in (
        (k_box, (C, 2, 3)), (k_s1, (C, 3)), (k_s2, (C, 3)))))
    dstate, ddiag = jtrain.make_densify_fn(dcfg, table)(copy.deepcopy(state1), dkey, jnp.asarray(True))

    p, aux, ttable, pose, tframe = carry(scene, table, params, frame)
    topts = port_opts(jopts)
    return dict(
        scene=scene, table=table, states=(state0, state1), scalars={k: np.asarray(v) for k, v in scalars.items()},
        draws=ttrain.Draws(torch.as_tensor(flip), None), cfg=cfg, dcfg=dcfg, noise=noise,
        dstate=dstate, ddiag=ddiag, ttable=ttable, pose=pose, frame=tframe, topts=topts,
        gt=convert.ground_truth_from_numpy(numpy_tree(gt), "cpu"),
    )


def test_render_opts_from_cfg_reads_semantics_and_normals():
    """runner.render_opts_from_cfg reads data.use_semantic,
    render.render_normal and model.gaussian.semantic_mode, as the JAX
    runner does."""
    cfg = t_default_config()
    cfg.data.use_semantic = True
    cfg.render.render_normal = True
    cfg.model.gaussian.semantic_mode = "probabilities"
    cfg.render.sky_downsample = 4
    o = render_opts_from_cfg(cfg, "eval")
    assert (o.use_semantic, o.render_normal, o.semantic_mode, o.sky_downsample) == (True, True, "probabilities", 4)
    assert render_opts_from_cfg(t_default_config(), "train").semantic_mode == "logits"


def test_train_step_with_semantics_and_normals_matches_jax(sem_step):
    """One train step at F = 27: every scalar, each leaf's gradient (from
    the JAX step's first Adam moment), the updated parameters; nothing
    supervises the extras, so the semantic rows' gradients are 0 and
    their values unchanged in both packages."""
    r = sem_step
    step_fn = ttrain.make_train_step(r["cfg"], r["ttable"], r["pose"], r["topts"])
    state0 = port_state(r["states"][0])
    _, _, grads, _, _ = step_fn.loss_and_grads(state0, r["frame"], r["gt"], draws=r["draws"])
    s1, sc = step_fn(state0, r["frame"], r["gt"], draws=r["draws"])
    want_sc = r["scalars"]
    # the port's step adds its instance counters (utils/trace.py's table)
    assert set(want_sc) == set(sc) - {"num_instances", "instance_fill"}
    assert float(sc["num_instances"]) > 0
    assert float(sc["instance_fill"]) == pytest.approx(float(sc["num_instances"]) / r["topts"].instance_capacity)
    for k, v in want_sc.items():
        if k.startswith("overflow") or k == "num_alive":
            assert int(sc[k]) == int(v), k
        else:
            np.testing.assert_allclose(float(sc[k]), float(v), rtol=1e-5, atol=1e-6, err_msg=k)
    js0, js1 = r["states"]
    want_mu = jax_flat(js1.adam.mu)
    alive = np.asarray(js1.aux.alive)
    assert (grads["gaussians.semantic"] == 0).all()
    assert (want_mu["gaussians.semantic"] == 0).all()
    for k, g in grads.items():
        g = g.numpy()
        if k.startswith(ttrain.GAUSS):
            g = g * alive.reshape((-1,) + (1,) * (g.ndim - 1))
        if k != "gaussians.semantic":
            grads_close(g, want_mu[k] / np.float32(0.1), f"grad {k}")
    sem0 = np.asarray(js0.params.gaussians.semantic)
    np.testing.assert_array_equal(np.asarray(js1.params.gaussians.semantic), sem0)
    np.testing.assert_array_equal(s1.params.gaussians.semantic.numpy(), sem0)
    want_p = jax_flat(js1.params)
    o = r["cfg"].optim
    lrs = {"gaussians.xyz": o.position_lr_init * 12.0, "gaussians.feat_dc": o.feature_lr,
           "gaussians.feat_rest": o.feature_lr / 20.0, "gaussians.log_scale": o.scaling_lr,
           "gaussians.rot": o.rotation_lr, "gaussians.opacity_logit": o.opacity_lr}
    for k, v in ttrain.flatten_params(s1.params).items():
        params_close(v.numpy(), want_p[k], want_mu[k], lrs.get(k, 0.0), 1, k)
    assert s1.step == 2501


def test_densify_keeps_semantic_rows_and_ply_matches_jax(sem_step, tmp_path):
    """A densify round of the stepped state with the JAX round's draws:
    the [C, 20] semantic rows follow their Gaussians (clones and splits
    copy them into the slots that pruning freed), alive rows and every
    parameter as JAX's; the PLY of JAX's densified state, carried across,
    has 20 semantic_i columns and is byte-equal to JAX's."""
    r = sem_step
    js = r["dstate"]
    pfn = ttrain.make_densify_fn(r["dcfg"], r["ttable"])
    s, diag = pfn(port_state(r["states"][1]), None, True, noise=r["noise"])
    for k, v in r["ddiag"].items():
        assert int(diag[k]) == int(v), k
    assert int(r["ddiag"]["points_clone"]) > 0 and int(r["ddiag"]["points_split"]) > 0
    np.testing.assert_array_equal(s.aux.alive.numpy(), np.asarray(js.aux.alive))
    want_p = jax_flat(js.params)
    for k, v in ttrain.flatten_params(s.params).items():
        np.testing.assert_allclose(v.numpy(), want_p[k], rtol=1e-6, atol=1e-6, err_msg=k)
    sem = s.params.gaussians.semantic.numpy()
    assert sem.shape == (r["table"].capacity, 20)
    # every alive row's semantic row is one of the rows before the round
    # (clones and splits land in freed slots with their source's row)
    before = r["states"][1].params.gaussians.semantic
    alive0, alive1 = np.asarray(r["states"][1].aux.alive), s.aux.alive.numpy()
    rows0 = {np.asarray(before)[i].tobytes() for i in np.flatnonzero(alive0)}
    assert all(sem[i].tobytes() in rows0 for i in np.flatnonzero(alive1))
    assert (sem[alive1] != np.asarray(before)[alive1]).any(axis=1).sum() > 0

    # the PLY of JAX's densified state, carried across, each package's
    # own writer
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    want = jckpt.save_point_cloud(jdir, 1, js.params.gaussians, js.aux, r["table"])
    carried = port_state(js)
    got = tckpt.save_point_cloud(tdir, 1, carried.params.gaussians, carried.aux, r["ttable"])
    assert filecmp.cmp(got, want, shallow=False)
    with open(got, "rb") as fh:
        header = fh.read(4096).split(b"end_header")[0].decode()
    assert all(f"semantic_{i}" in header for i in range(20)) and "semantic_20" not in header
    assert os.path.getsize(got) > 0


def test_blend_wrappers_refuse_features_past_the_cap():
    """All four blend wrappers take F up to MAX_FEATURES = 64 (here their
    plain versions, on the CPU) and refuse 0 and 65, naming the cap; the
    kernels share the cap, so a wide render fails alike on either device."""
    from chip_smoke import random_blend_case, random_table_case
    from street_gaussians_torch.ops import tile_raster, tile_raster2

    assert tile_raster2.MAX_FEATURES == 64
    case = random_blend_case(0, "cpu", grid_x=2, grid_y=2, max_count=150, F=64)
    payload, starts, counts, F, gx, T = case
    out = tile_raster2.tile_blend_instances(*case)
    assert out.shape == (T, 256, 65) and torch.isfinite(out).all()
    table = random_table_case(0, "cpu", grid_x=2, grid_y=2, K=256, F=64)
    assert tile_raster.tile_blend(*table).shape == (4, 256, 65)
    for bad in (0, 65):
        with pytest.raises(ValueError, match="MAX_FEATURES"):
            tile_raster2.tile_blend_instances(payload, starts, counts, bad, gx, T)
        with pytest.raises(ValueError, match="MAX_FEATURES"):
            tile_raster2.tile_blend_bwd(payload, starts, counts, out, out, bad, gx, T)
        with pytest.raises(ValueError, match="MAX_FEATURES"):
            tile_raster.tile_blend(table[0], table[1], bad, table[3])
        with pytest.raises(ValueError, match="MAX_FEATURES"):
            tile_raster.tile_blend_bwd(table[0], table[1], out, out, bad, table[3])
