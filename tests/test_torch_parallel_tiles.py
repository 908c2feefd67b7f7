"""The port's tile-row bands (parallel/tiles.py, ops/preprocess.clip_screen_to_rows,
the row windows of utils/camera.camera_rays and models/sky_cubemap.render_sky,
render_frame(row_shard=)) against the JAX package's, which runs its
sharded functions on the conftest's 8-device virtual CPU mesh with the
Pallas kernels in interpret mode.

Scenes: __graft_entry__._toy_setup at 32x48 (gy = 2: at D = 4 the bands
2 and 3 lie wholly past the image, H_pad = 64) and at 64x48 (gy = 4:
four non-empty bands at D = 4), one actor flipped with probability 0.5
in train mode, and a random 32-texel sky so that the sky's row windows
show. The bands run in turn in this process, and over a 2-rank Gloo
group whose ranks are spawned once for the module
(tests/torch_parallel_workers.py).

Tolerances, and why:
* clip_screen_to_rows on the same screen: every output equal (the same
  integer clips and one f32 subtraction);
* rays: rtol = atol = 1e-6 (the same f32 products); the sky: rtol = atol
  = 1e-5 (tests/test_torch_train.py's VJP tolerance, the lookup's
  f32 weights in another order);
* band renders: rtol = atol = 1e-5 on rgb, acc, depth, T and radii
  (tests/test_torch_render.py's); the overflow counters and the instance
  count equal;
* gradients of a band render and whole train steps: chip_smoke's
  grads_close and params_close, the rules of tests/test_torch_train.py;
  the loss within rtol 1e-5 (tests/test_tile_train.py's own); the
  densification counts equal;
* the bands' joined frame against the port's own whole frame at
  sky_downsample 1: rtol = atol = 1e-5 (the JAX suite's tests/test_tiles.py
  holds its own at 2e-5).

A reference-side fact (ROADMAP.md queue 3): at sky_downsample 2 a band
upsamples its own small sky image, whose rows clamp at the band's edge,
so the JAX package's joined bands differ from its whole frame on the two
rows beside each band edge where T > 0 (and on the image's last row
when the last band reaches past it); at 3 the band's 1/3 grid starts at
its own first row, off the whole frame's grid. The port reproduces the
bands, not the whole frame, there.
"""

import copy
import dataclasses
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as ge
import torch_parallel_workers as workers
from chip_smoke import grads_close, params_close
from street_gaussians_torch import convert
from street_gaussians_torch import runner as trunner
from street_gaussians_torch import train_lib as ttrain
from street_gaussians_torch.config import default_config as t_default_config
from street_gaussians_torch.config import load_config as t_load_config
from street_gaussians_torch.models import renderer as trend
from street_gaussians_torch.models.sky_cubemap import SkyParams as TSkyParams
from street_gaussians_torch.models.sky_cubemap import render_sky as t_render_sky
from street_gaussians_torch.ops.preprocess import GaussianScreenData as TScreen
from street_gaussians_torch.ops.preprocess import clip_screen_to_rows as t_clip
from street_gaussians_torch.parallel import tiles as ttiles
from street_gaussians_torch.utils.camera import camera_rays as t_rays
from street_gaussians_tpu import runner as jrunner
from street_gaussians_tpu import train_lib as jtrain
from street_gaussians_tpu.config import default_config as j_default_config
from street_gaussians_tpu.config import load_config as j_load_config
from street_gaussians_tpu.models import renderer as jrend
from street_gaussians_tpu.models.sky_cubemap import SkyParams as JSkyParams
from street_gaussians_tpu.models.sky_cubemap import render_sky as j_render_sky
from street_gaussians_tpu.ops.preprocess import clip_screen_to_rows as j_clip
from street_gaussians_tpu.parallel import tiles as jtiles
from street_gaussians_tpu.utils.camera import camera_rays as j_rays
from test_torch_runner import draw_free_overrides, one_thread, small_sensors, write_sequence  # noqa: F401
from test_torch_train import jax_flat, numpy_tree, port_state

TOL = dict(rtol=1e-5, atol=1e-5)
SKY = 32
FRAME = 1
# (H, bands D, sky_downsample)
RENDER_CASES = [(32, 2, 1), (32, 4, 1), (64, 4, 1), (64, 2, 2), (64, 4, 3)]
TRAIN_KEYS = (3, 4, 5)


def toy(H):
    """Both packages' toy scene at H x 48 with a random sky, random
    rotations and anisotropic scales (with the synthetic scene's identity
    rotations and isotropic scales the rotation gradient is 0 up to
    rounding: tests/test_torch_train.py)."""
    scene, params, opts = ge._toy_setup(H=H, num_actors=1)
    rng = np.random.default_rng(H)
    cube = rng.uniform(0.1, 0.9, (3, 6 * SKY * SKY)).astype(np.float32)
    g0 = params.gaussians
    C = scene.table.capacity
    alive = np.asarray(scene.aux.alive)[:, None]
    rot = np.where(alive, rng.normal(size=(C, 4)).astype(np.float32), np.asarray(g0.rot))
    log_scale = np.asarray(g0.log_scale) + rng.uniform(-0.4, 0.4, (C, 3)).astype(np.float32) * alive
    params = dataclasses.replace(
        params, sky=JSkyParams(cubemap=jnp.asarray(cube)),
        gaussians=dataclasses.replace(g0, rot=jnp.asarray(rot), log_scale=jnp.asarray(log_scale)))
    M = scene.table.num_models
    table = dataclasses.replace(scene.table, flip_prob=jnp.asarray([0.0] + [0.5] * (M - 1), jnp.float32))
    p, aux, ttable, pose = convert.scene_from_numpy(
        numpy_tree(params), numpy_tree(scene.aux), numpy_tree(table), numpy_tree(scene.pose_data), "cpu")
    return types.SimpleNamespace(
        jscene=scene, jparams=params, jtable=table, jopts=opts,
        params=p, aux=aux, table=ttable, pose=pose,
        frames=[convert.frame_from_numpy(numpy_tree(f), "cpu") for f in scene.frames],
        opts=trend.RenderOptions(mode="eval", tile_capacity=opts.tile_capacity,
                                 instance_capacity=opts.instance_capacity),
    )


@pytest.fixture(scope="module")
def scenes():
    return {H: toy(H) for H in (32, 64)}


def cfgs():
    """The JAX package's config for its step and the port's, equal key by
    key: tests/test_tile_train.py's loss weights and its object-opacity
    loss (lambda_reg 0.1)."""
    out = []
    for make in (j_default_config, t_default_config):
        cfg = make()
        cfg.optim.lambda_sky = 0.05
        cfg.optim.lambda_depth_lidar = 0.01
        cfg.optim.lambda_reg = 0.1
        out.append(cfg)
    return out


def ground_truth(s, seed=0, frame=FRAME):
    """tests/test_tile_train.py's _gts: the eval render plus noise."""
    f = s.jscene.frames[frame]
    H, W = f.cam.H, f.cam.W
    img = np.asarray(jrend.render_frame(s.jparams, s.jscene.aux, s.jtable, s.jscene.pose_data, f,
                                        step=jnp.asarray(0), opts=s.jopts)["rgb"])
    img = np.clip(img + np.random.default_rng(seed).normal(0, 0.05, img.shape), 0, 1).astype(np.float32)
    return jtrain.GroundTruth(
        image=jnp.asarray(img), mask=jnp.ones((H, W, 1), bool), sky_mask=jnp.zeros((H, W, 1), bool),
        lidar_depth=jnp.full((H, W), 8.0), obj_bound=jnp.zeros((H, W, 1), bool), sky_scale=jnp.ones(()),
    )


def draws_of(key, table, aux, H, W, fold=None):
    """The flip and sky jitter a JAX train step draws from `key`: the
    single and tile steps render with split(key)[0], the camera-parallel
    steps with fold_in(key, rank); the jitter is the full frame's."""
    k = jax.random.split(key)[0] if fold is None else jax.random.fold_in(key, fold)
    flip = np.asarray(jax.random.uniform(k, (table.capacity,))) < np.asarray(table.flip_prob)[np.asarray(aux.model_id)]
    jitter = np.asarray(jax.random.uniform(jax.random.fold_in(k, 1), (H, W, 2))) - 0.5
    return ttrain.Draws(torch.as_tensor(flip), torch.as_tensor(jitter.astype(np.float32)))


def dict_numpy(out):
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.fixture(scope="module")
def jax_bands(scenes):
    """The JAX package's row-sharded renders of every RENDER_CASES case,
    and its whole frames at sky_downsample 2."""
    res = {}
    for H, D, ds in RENDER_CASES:
        s = scenes[H]
        opts = dataclasses.replace(s.jopts, sky_downsample=ds)
        render = jtiles.make_row_sharded_render(s.jtable, s.jscene.pose_data, opts, jtiles.make_tile_mesh(D))
        res[(H, D, ds)] = dict_numpy(render(s.jparams, s.jscene.aux, s.jscene.frames[FRAME]))
    s = scenes[64]
    res["whole_ds2"] = dict_numpy(jrend.render_frame(
        s.jparams, s.jscene.aux, s.jtable, s.jscene.pose_data, s.jscene.frames[FRAME], step=jnp.asarray(10**9),
        opts=dataclasses.replace(s.jopts, sky_downsample=2)))
    return res


def cotangent(H, W):
    return (np.random.default_rng(0).standard_normal((H, W, 3)) * 1e-2).astype(np.float32)


@pytest.fixture(scope="module")
def jax_grads(scenes):
    """tests/test_tiles.py:54-95: gradients of sum(rgb * dl) through the
    JAX row-sharded render at D = 4 (two bands past the image)."""
    s = scenes[32]
    f = s.jscene.frames[FRAME]
    dl = cotangent(f.cam.H, f.cam.W)
    render = jtiles.make_row_sharded_render(s.jtable, s.jscene.pose_data, s.jopts, jtiles.make_tile_mesh(4))
    loss = lambda p: jnp.sum(render(p, s.jscene.aux, f)["rgb"] * dl)  # noqa: E731
    value, g = jax.value_and_grad(loss)(s.jparams)
    return {"dl": dl, "value": float(value), "grads": jax_flat(g)}


@pytest.fixture(scope="module")
def train_inputs(scenes):
    """The train steps' inputs: both packages' configs, the ground truth,
    the JAX state at the step before densify_until_iter (the first step
    collects the densification statistics, the next two add the actors'
    render in bands for the object-opacity loss,
    tests/test_tile_train.py:307) and the draws of keys TRAIN_KEYS."""
    s = scenes[32]
    jcfg, tcfg = cfgs()
    gt = ground_truth(s)
    f = s.jscene.frames[FRAME]
    start = jcfg.optim.densify_until_iter - 1
    state0 = dataclasses.replace(jtrain.init_train_state(s.jparams, s.jscene.aux), step=jnp.asarray(start, jnp.int32))
    draws = [draws_of(jax.random.PRNGKey(k), s.jtable, s.jscene.aux, f.cam.H, f.cam.W) for k in TRAIN_KEYS]
    return dict(jcfg=jcfg, tcfg=tcfg, jgt=gt, gt=convert.ground_truth_from_numpy(numpy_tree(gt), "cpu"),
                state0=state0, draws=draws)


@pytest.fixture(scope="module", autouse=True)
def band_group(scenes, train_inputs, tmp_path_factory):
    """The band group's cases on two spawned ranks, one band a rank,
    started first: they run while the module computes the JAX
    references."""
    s, r = scenes[32], train_inputs
    f = s.frames[FRAME]
    inputs = dict(
        table=s.table, pose=s.pose, params=s.params, aux=s.aux, frame=f, opts=s.opts,
        dl=torch.as_tensor(cotangent(f.cam.H, f.cam.W)), cfg=r["tcfg"],
        train_opts=dataclasses.replace(s.opts, mode="train"), state=port_state(r["state0"]), gt=r["gt"],
        draws=r["draws"],
    )
    ranks = workers.Ranks(str(tmp_path_factory.mktemp("band_group")), inputs,
                          ("band_render", "band_grads", "band_steps"))
    yield ranks
    ranks.close()


@pytest.fixture(scope="module")
def group_run(band_group):
    return band_group.results()


@pytest.fixture(scope="module")
def jax_train(scenes, train_inputs):
    """The JAX tile-sharded train step at D = 2 in train mode (flip and
    jitter drawn): three steps from train_inputs' state with its keys."""
    s, r = scenes[32], train_inputs
    f = s.jscene.frames[FRAME]
    jopts = dataclasses.replace(s.jopts, mode="train")
    step_fn = jtiles.make_tile_sharded_train_step(r["jcfg"], s.jtable, s.jscene.pose_data, jopts,
                                                  jtiles.make_tile_mesh(2))
    states, scalars = [r["state0"]], []
    for k in TRAIN_KEYS:
        st, sc = step_fn(copy.deepcopy(states[-1]), f, r["jgt"], jax.random.PRNGKey(k))
        states.append(st)
        scalars.append(dict_numpy(sc))
    return dict(states=states, scalars=scalars, draws=r["draws"], tcfg=r["tcfg"], gt=r["gt"])


# ---------------------------------------------------------------- pieces


@pytest.mark.parametrize("start,rows", [(0, 1), (1, 1), (3, 1), (1, 2), (0, 4), (5, 2)])
def test_clip_screen_to_rows_matches_jax(scenes, start, rows):
    """Bands inside, across and wholly past the 64-row frame's 4 tile
    rows, on JAX's own screen."""
    s = scenes[64]
    screen, _ = jrend.screen_space(s.jparams, s.jscene.aux, s.jtable, s.jscene.pose_data, s.jscene.frames[FRAME],
                                   jnp.asarray(10**9), opts=s.jopts)
    want = j_clip(screen, jnp.asarray(start), rows)
    got = t_clip(TScreen(*(torch.as_tensor(np.array(x)) for x in screen)), start, rows)
    kept, valid = np.asarray(want.valid), np.asarray(screen.valid)
    assert not (kept & ~valid).any() and (kept.any() if start < 4 else not kept.any())
    for name, g, w in zip(TScreen._fields, got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)


@pytest.mark.parametrize("ds,row_start,num_rows", [(1, 16, 32), (2, 48, 32), (3, 16, 32)])
def test_row_window_rays_and_sky_match_jax(scenes, ds, row_start, num_rows):
    """camera_rays and render_sky on a band's rows (one past the image's
    last), on the full grid (with train jitter) and on the 1/N grid."""
    s = scenes[64]
    jcam = s.jscene.frames[FRAME].cam
    tcam = s.frames[FRAME].cam
    jitter = None
    if ds == 1:
        jitter = (np.random.default_rng(row_start).uniform(size=(num_rows, jcam.W, 2)) - 0.5).astype(np.float32)
    jj = None if jitter is None else jnp.asarray(jitter)
    tj = None if jitter is None else torch.as_tensor(jitter)
    want = j_rays(jcam, jitter=jj, row_start=row_start, num_rows=num_rows, downsample=ds)
    got = t_rays(tcam, downsample=ds, jitter=tj, row_start=row_start, num_rows=num_rows)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    want = j_render_sky(s.jparams.sky, jcam, jitter=jj, interpret=True, row_start=row_start, num_rows=num_rows,
                        downsample=ds)
    got = t_render_sky(s.params.sky, tcam, downsample=ds, jitter=tj, row_start=row_start, num_rows=num_rows)
    assert tuple(got.shape) == (-(-num_rows // ds), -(-jcam.W // ds), 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_band_layout():
    """tiles.py:64-68: 1064 rows in 4 bands: gy 67, 17 tile rows a band,
    1088 rows padded; 32 rows in 4 bands: the last two past the image."""
    lay = ttiles.band_layout(1064, 4)
    assert (lay.gy, lay.gy_local, lay.H_pad) == (67, 17, 1088)
    assert [lay.band(d) for d in range(4)] == [(0, 17), (17, 17), (34, 17), (51, 17)]
    lay = ttiles.band_layout(32, 4)
    assert (lay.gy, lay.gy_local, lay.H_pad) == (2, 1, 64)
    assert ttiles.band_capacity(1536 * 1024, 4) == 393216 and ttiles.band_capacity(2**13, 16) == 1024


# ---------------------------------------------------------------- renders


def assert_render_close(got, want, what):
    for k in ("rgb", "acc", "depth", "T", "radii"):
        np.testing.assert_allclose(got[k].detach().numpy(), want[k], err_msg=f"{what} {k}", **TOL)
    np.testing.assert_array_equal(got["visibility"].numpy(), want["visibility"])
    for k in ttiles.COUNTERS:
        assert int(got[k]) == int(want[k]), (what, k)


@pytest.mark.parametrize("H,D,ds", RENDER_CASES)
def test_band_render_matches_jax(scenes, jax_bands, H, D, ds):
    """make_row_sharded_render, the bands in turn, against JAX's on its
    mesh; at sky_downsample 1 the joined bands also equal the port's own
    whole frame."""
    s = scenes[H]
    opts = dataclasses.replace(s.opts, sky_downsample=ds)
    render = ttiles.make_row_sharded_render(s.table, s.pose, opts, D)
    with torch.no_grad():
        got = render(s.params, s.aux, s.frames[FRAME])
    want = jax_bands[(H, D, ds)]
    assert got["rgb"].shape == (H, 48, 3) and int(want["overflow"]) == 0
    assert_render_close(got, want, f"H={H} D={D} ds={ds}")
    if ds == 1:
        with torch.no_grad():
            whole = trend.render_frame(s.params, s.aux, s.table, s.pose, s.frames[FRAME], 10**9, opts=opts)
        for k in ("rgb", "acc", "depth", "T", "radii"):
            np.testing.assert_allclose(got[k].numpy(), whole[k].numpy(), err_msg=k, **TOL)
        assert int(got["num_instances"]) == int(whole["num_instances"])


def test_jax_bands_differ_from_whole_frame_at_band_edges(scenes, jax_bands):
    """The reference-side fact of the module's docstring, on JAX's own
    outputs: at sky_downsample 2, 2 bands of 32 rows, the joined frame
    equals the whole frame but on rows 31 and 32."""
    got, whole = jax_bands[(64, 2, 2)], jax_bands["whole_ds2"]
    off = np.abs(got["rgb"] - whole["rgb"]).max(axis=(1, 2)) > 1e-5
    assert set(np.nonzero(off)[0]) == {31, 32}
    np.testing.assert_allclose(got["acc"], whole["acc"], **TOL)


def test_band_group_render_matches_jax(group_run, jax_bands):
    """Two ranks, one band each: both get the whole frame."""
    for r, res in enumerate(group_run):
        assert_render_close(res["band_render"], jax_bands[(32, 2, 1)], f"rank {r}")


def assert_grads(got, got_value, ref):
    want = ref["grads"]
    np.testing.assert_allclose(float(got_value), ref["value"], rtol=1e-5)
    assert set(got) == set(want)
    for k, g in got.items():
        grads_close(g.numpy(), want[k], f"grad {k}")


def test_band_render_gradients_match_jax(scenes, jax_grads):
    """Autograd through the joined bands (D = 4, two past the image)."""
    s = scenes[32]
    flat = {k: v.detach().requires_grad_(True) for k, v in ttrain.flatten_params(s.params).items()}
    render = ttiles.make_row_sharded_render(s.table, s.pose, s.opts, 4)
    out = render(ttrain.unflatten_params(flat, s.params), s.aux, s.frames[FRAME])
    loss = (out["rgb"] * torch.as_tensor(jax_grads["dl"])).sum()
    grads = torch.autograd.grad(loss, list(flat.values()), allow_unused=True)
    got = {k: torch.zeros_like(x) if g is None else g for (k, x), g in zip(flat.items(), grads)}
    assert_grads(got, loss.detach(), jax_grads)


def test_band_group_gradients_match_jax(group_run, jax_grads):
    """Over the band group: loss / D, the gather's reduce-scatter and one
    sum over the group; both ranks the same bits."""
    for res in group_run:
        assert_grads(res["band_grads"]["grads"], res["band_grads"]["loss"], jax_grads)
    for k, g in group_run[0]["band_grads"]["grads"].items():
        assert torch.equal(g, group_run[1]["band_grads"]["grads"][k]), k


# ---------------------------------------------------------------- train steps


def lr_bound(cfg, name):
    o = cfg.optim
    return {
        "gaussians.xyz": o.position_lr_init * 20.0, "gaussians.feat_dc": o.feature_lr,
        "gaussians.feat_rest": o.feature_lr / 20.0, "gaussians.log_scale": o.scaling_lr,
        "gaussians.rot": o.rotation_lr, "gaussians.opacity_logit": o.opacity_lr,
        "sky.cubemap": o.sky_cube_map_lr_init, "actor_pose.opt_trans": o.track_position_lr_init,
        "actor_pose.opt_rots": o.track_rotation_lr_init,
    }.get(name, 0.0)


def assert_state_matches(got, js, js1, cfg, steps):
    """A port state ({params, mu, nu, count, aux} of
    torch_parallel_workers._state_numpy, or a TrainState) against JAX's
    after `steps` steps; js1: JAX's state after the first step."""
    if isinstance(got, ttrain.TrainState):
        got = workers._state_numpy(got)
    want_p, g1 = jax_flat(js.params), jax_flat(js1.adam.mu)
    assert set(got["params"]) == set(want_p)
    for k, v in got["params"].items():
        params_close(v.numpy(), want_p[k], g1[k], lr_bound(cfg, k), steps, k)
    want_mu = jax_flat(js.adam.mu)
    alive = np.asarray(js.aux.alive)
    for k, v in got["mu"].items():
        v = v.numpy()
        if k.startswith(ttrain.GAUSS):
            v = v * alive.reshape((-1,) + (1,) * (v.ndim - 1))
        grads_close(v, want_mu[k], f"mu {k}")
    want_c = jax_flat(js.adam.count)
    for k, v in got["count"].items():
        np.testing.assert_array_equal(v.numpy(), want_c[k], err_msg=f"count {k}")
    np.testing.assert_array_equal(got["aux"]["denom"].numpy(), np.asarray(js.aux.denom))
    np.testing.assert_allclose(got["aux"]["max_radii"].numpy(), np.asarray(js.aux.max_radii), **TOL)
    for c in range(2):
        grads_close(got["aux"]["grad_accum"][:, c].numpy(), np.asarray(js.aux.grad_accum)[:, c],
                    f"grad_accum[:, {c}]")


# the port's instance counters, in its step's scalars alone (utils/trace.py)
PORT_KEYS = {"num_instances", "instance_fill"}


def assert_scalars(got, want):
    """The JAX step renders the actors before the gate too and weighs
    their loss by 0 (tests/test_torch_object_loss.py): obj_acc_loss only
    where the port has it; the port's instance counters (PORT_KEYS) are
    its own."""
    assert PORT_KEYS <= set(got)
    got = {k: v for k, v in got.items() if k not in PORT_KEYS}
    assert set(got) <= set(want) and set(want) - set(got) <= {"obj_acc_loss"}
    for k, v in want.items():
        if k not in got:
            continue
        if k.startswith("overflow") or k == "num_alive":
            assert int(got[k]) == int(v), k
        else:
            np.testing.assert_allclose(float(got[k]), float(v), rtol=1e-5, atol=1e-6, err_msg=k)


@pytest.fixture(scope="module")
def port_turns(scenes, jax_train):
    """The port's tile step at D = 2, the bands in turn, on the JAX
    steps' draws: each step's state and scalars."""
    s, r = scenes[32], jax_train
    step_fn = ttiles.make_tile_sharded_train_step(r["tcfg"], s.table, s.pose, dataclasses.replace(s.opts, mode="train"), 2)
    state, states, scalars = port_state(r["states"][0]), [], []
    for d in r["draws"]:
        state, sc = step_fn(state, s.frames[FRAME], r["gt"], draws=d)
        states.append(workers._state_numpy(state))
        scalars.append(sc)
    return states, scalars


@pytest.mark.parametrize("where", ["in_turn", "band_group"])
def test_tile_sharded_steps_match_jax(jax_train, port_turns, group_run, where):
    """tests/test_tile_train.py:119-228 in train mode: one and three
    steps at D = 2 with the JAX steps' own draws."""
    r = jax_train
    states, scalars = port_turns
    if where == "band_group":
        states, scalars = group_run[0]["band_steps"]["states"], group_run[0]["band_steps"]["scalars"]
        for k, v in states[-1]["params"].items():
            assert torch.equal(v, group_run[1]["band_steps"]["states"][-1]["params"][k]), k
    for i in range(3):
        assert_scalars(scalars[i], r["scalars"][i])
    assert_state_matches(states[0], r["states"][1], r["states"][1], r["tcfg"], 1)
    assert_state_matches(states[2], r["states"][3], r["states"][1], r["tcfg"], 3)


def test_tile_sharded_object_loss_pass_matches_jax(jax_train, port_turns):
    """tests/test_tile_train.py:307: from densify_until_iter on the actors
    render alone in bands as well; their loss is in the scalars of the
    second and third steps, and the gradients carry it (the steps above)."""
    _, scalars = port_turns
    assert "obj_acc_loss" not in scalars[0]
    for i in (1, 2):
        assert float(scalars[i]["obj_acc_loss"]) > 0
        np.testing.assert_allclose(float(scalars[i]["obj_acc_loss"]), float(jax_train["scalars"][i]["obj_acc_loss"]),
                                   rtol=1e-5)


# ---------------------------------------------------------------- runner


def test_render_parallel_tile_through_the_runner(tmp_path):
    """render.parallel tile=2: make_eval_render against JAX's (the JAX
    package's tests/test_tiles.py::test_render_parallel_config_path) on
    the same parameters, and render_sets' PNGs against those rendered
    without it (u8 of renders within 1e-5: within 1)."""
    root = str(tmp_path / "seq")
    write_sequence(root, num_frames=2)
    over = [*draw_free_overrides(root, str(tmp_path / "out"), 1), "model.nsg.include_sky", "true",
            "model.sky.resolution", str(SKY), "render.auto_size_capacity", "false"]
    jcfg, tcfg = j_load_config(None, over), t_load_config(None, over)
    np.random.seed(0)
    jscene = jrunner.build_scene(jcfg)
    jparams = jrunner.build_initial_params(jcfg, jscene)
    np.random.seed(0)
    tscene = trunner.build_scene(tcfg, device="cpu")
    p = convert.scene_from_numpy(numpy_tree(jparams), numpy_tree(jscene.aux_init), None, None, "cpu")
    state = ttrain.init_train_state(p[0], p[1])
    jcfg.render.parallel = tcfg.render.parallel = "tile=2"
    jr = jrunner.make_eval_render(jcfg, jscene)
    tr = trunner.make_eval_render(tcfg, tscene)
    for jv, tv in zip(jscene.train_views, tscene.train_views):
        want = jr(jparams, jscene.aux_init, jv.frame_input)
        got = tr(state.params, state.aux, tv.frame_input)
        for k in ("rgb", "acc", "depth"):
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), err_msg=k, **TOL)
        assert int(got["overflow_instance"]) == int(want["overflow_instance"]) == 0

    pngs = {}
    for par in ("", "tile=2"):
        c = copy.deepcopy(tcfg)
        c.model_path = str(tmp_path / f"serve{par.replace('=', '')}")
        c.render.parallel = par
        c.mode = "evaluate"
        trunner.render_sets(c, state=state, scene=tscene, device="cpu")
        d = os.path.join(c.model_path, "train_renders")
        pngs[par] = {f: trunner.imread(os.path.join(d, f)).astype(int) for f in sorted(os.listdir(d))}
    assert list(pngs[""]) == list(pngs["tile=2"]) and len(pngs[""]) == 2
    for f in pngs[""]:
        assert np.abs(pngs[""][f] - pngs["tile=2"][f]).max() <= 1, f


def test_sharded_parallel_kinds_raise(tmp_path):
    """gauss=N and gausstile=GxT give the Gaussian-sharded renderers (in
    turn: tests/test_torch_parallel_gauss.py holds them against JAX); a
    capacity that N does not divide and unknown kinds are refused as the
    JAX runner refuses them."""
    cfg = t_default_config()
    table = types.SimpleNamespace(start_frame=torch.zeros(1), capacity=8, slices=np.array([[0, 8]]))
    scene = types.SimpleNamespace(table=table, pose_data=None)
    for par, G in (("gauss=2", 2), ("gausstile=2x2", 2), ("gauss=4", 4)):
        cfg.render.parallel = par
        assert trunner.make_eval_render(cfg, scene).shards.G == G
    cfg.render.parallel = "gauss=3"
    with pytest.raises(RuntimeError, match="capacity 8 must divide the 'gauss' axis size 3"):
        trunner.make_eval_render(cfg, scene)
    cfg.render.parallel = "rows=2"
    with pytest.raises(ValueError, match="unknown kind"):
        trunner.make_eval_render(cfg, scene)
