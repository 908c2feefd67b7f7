"""Include masks and the object-opacity loss in the port, against the JAX
package (Pallas in interpret mode, jitted): the three mask helpers, the
object-only and background-only renders and compose_sky=False, the
loss with out_obj, two train steps with lambda_reg = 0.1 on a toy scene
with actors (one on each side of densify_until_iter, densification
statistics included), the white-background opacity reset of
train.run_step, and four render options checked by no other test.

Tolerances: renders as tests/test_torch_render.py (rtol = atol = 1e-5;
integer counts equal); losses and their gradients rtol = atol = 1e-5;
train steps as tests/test_torch_train.py (chip_smoke.grads_close and
params_close); masks and integers equal.
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import grads_close
from street_gaussians_torch import convert
from street_gaussians_torch import train as ttrain_cli
from street_gaussians_torch import train_lib as ttrain
from street_gaussians_torch.models import renderer as trend
from street_gaussians_tpu import train_lib as jtrain
from street_gaussians_tpu.config import default_config
from street_gaussians_tpu.data.synthetic import make_synthetic_scene
from street_gaussians_tpu.models import gaussians as jG
from street_gaussians_tpu.models import renderer as jrend
from street_gaussians_tpu.models.sky_cubemap import SkyParams
from street_gaussians_tpu.optim.adam import AdamState as JAdamState
from test_torch_train import _assert_state_close, jax_flat, numpy_tree, port_state

TOL = dict(rtol=1e-5, atol=1e-5)
START_STEP = 2500  # SH degree 2 active; densify_until_iter = START_STEP + 1


def carry(scene, params, table=None):
    return convert.scene_from_numpy(
        numpy_tree(params), numpy_tree(scene.aux), numpy_tree(table or scene.table),
        numpy_tree(scene.pose_data), "cpu",
    )


def port_opts(jopts, **kw):
    fields = {f.name for f in dataclasses.fields(trend.RenderOptions)}
    return trend.RenderOptions(**{k: v for k, v in dataclasses.asdict(jopts).items() if k in fields}, **kw)


def assert_same_render(got, want, what=""):
    for k in ("rgb", "depth", "acc", "T", "radii"):
        np.testing.assert_allclose(got[k].detach().numpy(), np.asarray(want[k]), err_msg=f"{what} {k}", **TOL)
    for k in ("num_instances", "overflow"):
        assert int(got[k]) == int(want[k]), f"{what} {k}"


@pytest.fixture(scope="module")
def sky_scene():
    """64x96, 2 actors, a random 16-texel sky."""
    scene = make_synthetic_scene(num_bkgd=300, num_actors=2, H=64, W=96, seed=3, round_to=128)
    rng = np.random.default_rng(4)
    params = jrend.SceneParams(
        gaussians=scene.params_init, actor_pose=scene.pose_params_init,
        sky=SkyParams(cubemap=jnp.asarray(rng.uniform(0, 1, (3, 6 * 16 * 16)).astype(np.float32))),
        color_correction=None, pose_correction=None,
    )
    return scene, params


# ---------------------------------------------------------------- masks


def test_mask_helpers_match_jax():
    """include_mask_for (include and exclude lists, unknown names),
    render_object_mask and render_background_mask, on a table with a
    sky-as-Gaussians model and on one without."""
    for sky in (False, True):
        rng = np.random.default_rng(0)
        pts = {n: rng.normal(size=(30, 3)).astype(np.float32) for n in ("background", "obj_001", "obj_004")}
        cols = {n: np.full((30, 3), 0.5, np.float32) for n in pts}
        extra = dict(sky_points=rng.normal(size=(20, 3)).astype(np.float32) * 50,
                     sky_colors=np.full((20, 3), 0.5, np.float32)) if sky else {}
        _, _, jtable = jG.pack_scene(pts, cols, round_to=64, **extra)
        ttable = convert.scene_from_numpy(
            {"gaussians": None}, None, numpy_tree(jtable), None, "cpu")[2]
        assert ttable.sky_model == jtable.sky_model == (3 if sky else -1)
        for fn in ("render_object_mask", "render_background_mask"):
            np.testing.assert_array_equal(getattr(trend, fn)(ttable), getattr(jrend, fn)(jtable), err_msg=fn)
        for kw in (dict(), dict(include=["obj_004", "nope"]), dict(exclude=["background", "sky"]),
                   dict(include=["background", "obj_001"], exclude=["obj_001"])):
            np.testing.assert_array_equal(trend.include_mask_for(ttable, **kw),
                                          jrend.include_mask_for(jtable, **kw), err_msg=str(kw))


# ---------------------------------------------------------------- renders


def test_subset_renders_match_jax(sky_scene):
    """The actors alone without the sky (as the object loss renders
    them), the background alone with the sky, and the whole scene
    without the sky, in eval mode (the actors' mask also as a tensor);
    then the relations of
    tests/test_scene_model.py::test_render_subsets_compose."""
    scene, params = sky_scene
    frame = scene.frames[4]
    jopts = jrend.RenderOptions(mode="eval", tile_capacity=2**13, instance_capacity=2**13, interpret=True)
    obj_m, bkg_m = jrend.render_object_mask(scene.table), jrend.render_background_mask(scene.table)
    cases = {"object": dict(include_mask=obj_m, compose_sky=False), "background": dict(include_mask=bkg_m),
             "no sky": dict(compose_sky=False), "full": dict()}

    @jax.jit
    def j_renders(p):
        return {k: jrend.render_frame(p, scene.aux, scene.table, scene.pose_data, frame, step=jnp.asarray(0),
                                      opts=jopts, **kw) for k, kw in cases.items()}

    want = j_renders(params)
    p, aux, table, pose = carry(scene, params)
    f = convert.frame_from_numpy(numpy_tree(frame), "cpu")
    got = {k: trend.render_frame(p, aux, table, pose, f, 0, opts=port_opts(jopts), **kw) for k, kw in cases.items()}
    for k in cases:
        assert_same_render(got[k], want[k], k)
    # the mask as a tensor (as the train step passes it): the same bits
    as_tensor = trend.render_frame(p, aux, table, pose, f, 0, opts=port_opts(jopts),
                                   include_mask=torch.as_tensor(obj_m), compose_sky=False)
    for k in ("rgb", "depth", "acc", "T"):
        assert torch.equal(as_tensor[k], got["object"][k]), k
    acc = {k: float(v["acc"].sum()) for k, v in got.items()}
    assert 0 < acc["object"] < acc["background"] and acc["full"] > max(acc["object"], acc["background"]) * 0.99
    # without the sky the background shows where T is left
    assert float((got["full"]["rgb"] - got["no sky"]["rgb"]).abs().max()) > 0.1


@pytest.mark.parametrize("option", ["white_background", "scaling_modifier", "max_tiles_per_gaussian",
                                    "train_without_draws"])
def test_render_options_match_jax(option):
    """One render each with white_background=True, scaling_modifier=0.7,
    max_tiles_per_gaussian=4 and train mode without draws (no flip, no
    jitter), on a 32x48 scene with an actor and a sky."""
    scene = make_synthetic_scene(num_bkgd=200, num_actors=1, H=32, W=48, seed=5, round_to=128)
    rng = np.random.default_rng(6)
    params = jrend.SceneParams(
        gaussians=scene.params_init, actor_pose=scene.pose_params_init,
        sky=SkyParams(cubemap=jnp.asarray(rng.uniform(0, 1, (3, 6 * 8 * 8)).astype(np.float32))),
        color_correction=None, pose_correction=None,
    )
    kw = {"white_background": dict(white_background=True), "scaling_modifier": dict(scaling_modifier=0.7),
          "max_tiles_per_gaussian": dict(max_tiles_per_gaussian=4),
          "train_without_draws": dict(mode="train")}[option]
    jopts = jrend.RenderOptions(**{"mode": "eval", **kw}, tile_capacity=2**13, instance_capacity=2**13,
                                interpret=True)
    frame = scene.frames[3]
    want = jax.jit(lambda p: jrend.render_frame(p, scene.aux, scene.table, scene.pose_data, frame,
                                                step=jnp.asarray(600), opts=jopts))(params)
    p, aux, table, pose = carry(scene, params)
    f = convert.frame_from_numpy(numpy_tree(frame), "cpu")
    assert_same_render(trend.render_frame(p, aux, table, pose, f, 600, opts=port_opts(jopts)), want, option)


# ---------------------------------------------------------------- losses


def test_compute_losses_with_out_obj_match_jax():
    """The object-opacity term on a fake object render (the JAX step's
    weight after the gate, 1): values of every scalar and the gradients
    in both renders' acc (pixels at 0 and 1 reach the clamp)."""
    rng = np.random.default_rng(7)
    H, W = 20, 24
    pred = rng.uniform(0, 1, (H, W, 3)).astype(np.float32)
    gt_img = np.clip(pred + rng.normal(0, 0.1, pred.shape), 0, 1).astype(np.float32)
    acc = rng.uniform(0, 1, (H, W)).astype(np.float32)
    acc_obj = (acc * rng.uniform(0, 1, (H, W))).astype(np.float32)
    acc_obj[0, :3] = [0.0, 1.0, 0.5]
    obj_bound = rng.uniform(size=(H, W, 1)) < 0.4
    cfg = default_config()
    cfg.optim.lambda_sky = 0.05
    cfg.optim.lambda_reg = 0.1
    jgt = jtrain.GroundTruth(
        image=jnp.asarray(gt_img), mask=jnp.ones((H, W, 1), bool),
        sky_mask=jnp.asarray(rng.uniform(size=(H, W, 1)) < 0.3), lidar_depth=jnp.zeros((H, W)),
        obj_bound=jnp.asarray(obj_bound), sky_scale=jnp.asarray(1.0),
    )

    def j_loss(a, ao):
        return jtrain.compute_losses(
            {"rgb": jnp.asarray(pred), "acc": a, "depth": a}, {"acc": ao}, jgt,
            jrend.SceneParams(None, None, None, None, None), cfg, 0, jnp.asarray(1.0),
        )

    (want, want_sc), want_g = jax.value_and_grad(j_loss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(acc), jnp.asarray(acc_obj))
    ins = [torch.as_tensor(x).requires_grad_(True) for x in (acc, acc_obj)]
    got, got_sc = ttrain.compute_losses(
        {"rgb": torch.as_tensor(pred), "acc": ins[0], "depth": ins[0]},
        convert.ground_truth_from_numpy(numpy_tree(jgt), "cpu"),
        trend.SceneParams(None, None, None, None, None), cfg, 0,
        out_obj={"acc": ins[1]},
    )
    got.backward()
    assert set(got_sc) == set(want_sc) and "obj_acc_loss" in got_sc
    for k in want_sc:
        np.testing.assert_allclose(float(got_sc[k]), float(want_sc[k]), err_msg=k, **TOL)
    for name, a, w in zip(("acc", "acc_obj"), ins, want_g):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(w), err_msg=name, **TOL)


# ---------------------------------------------------------------- train steps


def _fresh_adam(js):
    """The JAX state with zero moments and counts (a step's first Adam
    moment is then 0.1 x its gradient)."""
    return dataclasses.replace(jtrain.init_train_state(js.params, js.aux), step=js.step)


@pytest.fixture(scope="module")
def gate_run():
    """The JAX train step with lambda_reg = 0.1 on a 64x96 scene with 2
    actors (flipped with probability 0.5), a random sky and an obj_bound
    from the actors' own render: step START_STEP (before the gate), then
    START_STEP + 1 = densify_until_iter (the object loss on), and the
    second step again from fresh Adam moments; each step's draws."""
    scene = make_synthetic_scene(num_bkgd=300, num_actors=2, H=64, W=96, seed=3, round_to=128)
    M = scene.table.num_models
    table = dataclasses.replace(scene.table, flip_prob=jnp.asarray([0.0] + [0.5] * (M - 1), jnp.float32))
    rng = np.random.default_rng(6)
    g0, C = scene.params_init, scene.table.capacity
    alive0 = np.asarray(scene.aux.alive)[:, None]
    rot = np.where(alive0, rng.normal(size=(C, 4)), np.asarray(g0.rot)).astype(np.float32)
    log_scale = np.asarray(g0.log_scale) + rng.uniform(-0.4, 0.4, (C, 3)).astype(np.float32) * alive0
    params = jrend.SceneParams(
        gaussians=dataclasses.replace(g0, rot=jnp.asarray(rot), log_scale=jnp.asarray(log_scale)),
        actor_pose=scene.pose_params_init,
        sky=SkyParams(cubemap=jnp.asarray(rng.uniform(0.2, 0.8, (3, 6 * 16 * 16)).astype(np.float32))),
        color_correction=None, pose_correction=None,
    )
    cap = 2**14
    jopts = jrend.RenderOptions(mode="train", tile_capacity=cap, instance_capacity=cap, interpret=True)
    frame = scene.frames[2]
    H, W = frame.cam.H, frame.cam.W
    eval_opts = dataclasses.replace(jopts, mode="eval")
    full, obj = jax.jit(lambda p: [jrend.render_frame(
        p, scene.aux, table, scene.pose_data, frame, step=jnp.asarray(START_STEP), opts=eval_opts, include_mask=m)
        for m in (None, jrend.render_object_mask(table))])(params)
    img = np.clip(np.asarray(full["rgb"]) + rng.normal(0, 0.05, (H, W, 3)), 0, 1).astype(np.float32)
    obj_bound = np.asarray(obj["acc"])[..., None] > 0.2
    gt = jtrain.GroundTruth(
        image=jnp.asarray(img), mask=jnp.ones((H, W, 1), bool),
        sky_mask=jnp.asarray(rng.uniform(size=(H, W, 1)) < 0.3),
        lidar_depth=jnp.full((H, W), 8.0, jnp.float32), obj_bound=jnp.asarray(obj_bound),
        sky_scale=jnp.ones(()),
    )
    cfg = default_config()
    cfg.optim.lambda_sky = 0.05
    cfg.optim.lambda_depth_lidar = 0.1
    cfg.optim.lambda_reg = 0.1
    cfg.optim.densify_until_iter = START_STEP + 1
    state0 = dataclasses.replace(jtrain.init_train_state(params, scene.aux), step=jnp.asarray(START_STEP, jnp.int32))
    step_fn = jtrain.make_train_step(cfg, table, scene.pose_data, jopts, donate=False)
    states, scalars, draws = [state0], [], []
    for i in range(2):
        key = jax.random.PRNGKey(30 + i)
        k_render, _ = jax.random.split(key)
        flip = np.asarray(jax.random.uniform(k_render, (C,))) < np.asarray(table.flip_prob)[np.asarray(scene.aux.model_id)]
        jitter = np.asarray(jax.random.uniform(jax.random.fold_in(k_render, 1), (H, W, 2))) - 0.5
        draws.append(ttrain.Draws(torch.as_tensor(flip), torch.as_tensor(jitter.astype(np.float32))))
        s, sc = step_fn(copy.deepcopy(states[-1]), frame, gt, key)
        states.append(s)
        scalars.append({k: np.asarray(v) for k, v in sc.items()})
        if i == 1:
            fresh, _ = step_fn(_fresh_adam(copy.deepcopy(states[1])), frame, gt, key)
    assert all(d.flip.any() for d in draws) and obj_bound.sum() > 20

    p, aux, ttable, pose = carry(scene, params, table)
    tframe = convert.frame_from_numpy(numpy_tree(frame), "cpu")
    topts = trend.RenderOptions(mode="train", tile_capacity=cap, instance_capacity=cap)
    no_reg = copy.deepcopy(cfg)
    no_reg.optim.lambda_reg = 0.0
    port = dict(step_fn=ttrain.make_train_step(cfg, ttable, pose, topts),
                no_reg_step_fn=ttrain.make_train_step(no_reg, ttable, pose, topts),
                frame=tframe, gt=convert.ground_truth_from_numpy(numpy_tree(gt), "cpu"))
    return dict(states=states, scalars=scalars, draws=draws, fresh=fresh, cfg=cfg, port=port)


def _check_grads(grads, js_after, alive, what):
    want_mu = jax_flat(js_after.adam.mu)
    for k, g in grads.items():
        g = g.numpy()
        if k.startswith(ttrain.GAUSS):
            g = g * alive.reshape((-1,) + (1,) * (g.ndim - 1))
        grads_close(g, want_mu[k] / np.float32(0.1), f"{what} grad {k}")


def test_step_before_the_gate_matches_jax(gate_run):
    """Step START_STEP < densify_until_iter: the JAX step renders the
    actors and weighs their loss by 0, the port skips that render. Every
    scalar but obj_acc_loss, every gradient, and the densification
    statistics collected by this step."""
    r, port = gate_run, gate_run["port"]
    state0 = port_state(r["states"][0])
    sc, _, grads, _, _ = port["step_fn"].loss_and_grads(state0, port["frame"], port["gt"], draws=r["draws"][0])
    want = r["scalars"][0]
    assert set(want) - set(sc) >= {"obj_acc_loss"} and "obj_acc_loss" not in sc
    for k in set(sc) & set(want):
        np.testing.assert_allclose(float(sc[k]), float(want[k]), rtol=1e-5, atol=1e-6, err_msg=k)
    _check_grads(grads, r["states"][1], np.asarray(r["states"][1].aux.alive), "before the gate")
    s1, _ = port["step_fn"](state0, port["frame"], port["gt"], draws=r["draws"][0])
    assert float(s1.aux.denom.sum()) > 0
    _assert_state_close(s1, r["states"][1], r, steps=1)


def test_step_at_the_gate_matches_jax(gate_run):
    """Step densify_until_iter: the second render of the actors alone
    (same flip, no sky) and its loss. Every scalar (obj_acc_loss > 0),
    every gradient (the sum of both renders'), and the view-space
    gradients that densification reads, which only the first render
    feeds: equal to those of the same step without the object loss."""
    r, port = gate_run, gate_run["port"]
    s1 = port_state(_fresh_adam(r["states"][1]))
    args = (s1, port["frame"], port["gt"])
    sc, _, grads, g_m2d, g_abs = port["step_fn"].loss_and_grads(*args, draws=r["draws"][1])
    want = r["scalars"][1]
    assert "obj_acc_loss" in want and float(sc["obj_acc_loss"]) > 0
    for k in set(sc) & set(want):
        np.testing.assert_allclose(float(sc[k]), float(want[k]), rtol=1e-5, atol=1e-6, err_msg=k)
    _check_grads(grads, r["fresh"], np.asarray(r["fresh"].aux.alive), "at the gate")
    sc0, _, grads0, g_m2d0, g_abs0 = port["no_reg_step_fn"].loss_and_grads(*args, draws=r["draws"][1])
    assert "obj_acc_loss" not in sc0
    np.testing.assert_allclose(g_m2d.numpy(), g_m2d0.numpy(), rtol=1e-6, atol=1e-12)
    np.testing.assert_allclose(g_abs.numpy(), g_abs0.numpy(), rtol=1e-6, atol=1e-12)
    assert float(g_m2d.abs().max()) > 0
    # the object loss moves the actors' rows
    rows = torch.as_tensor(np.array(r["fresh"].aux.model_id)) > 0
    assert float((grads["gaussians.opacity_logit"] - grads0["gaussians.opacity_logit"])[rows].abs().max()) > 0


def test_two_steps_across_the_gate_match_jax(gate_run):
    """Both steps in a row from the same state: parameters, moments,
    step counts and densification statistics against the JAX state."""
    r, port = gate_run, gate_run["port"]
    s = port_state(r["states"][0])
    for i in range(2):
        s, sc = port["step_fn"](s, port["frame"], port["gt"], draws=r["draws"][i])
        np.testing.assert_allclose(float(sc["loss"]), float(r["scalars"][i]["loss"]), rtol=1e-5)
        assert int(sc["overflow"]) == 0
    assert s.step == START_STEP + 2
    _assert_state_close(s, r["states"][2], r, steps=2)


# ---------------------------------------------------------------- white-background reset


def test_white_background_resets_opacity_at_densify_from_iter():
    """train.run_step with data.white_background: the step that reaches
    densify_from_iter resets the opacities (the reference's extra reset),
    as the JAX make_reset_opacity_fn does; without white_background the
    same step leaves them."""
    results = {}
    for white in (True, False):
        cell = ttrain_cli.bench_train_cell("cpu", seed=3, sky_resolution=8, num_bkgd=200, num_actors=1, H=32, W=48)
        o = cell.cfg.optim
        o.densify_from_iter = 1
        o.densification_interval, o.opacity_reset_interval = 100, 3000
        cell.cfg.data.white_background = white
        gen = torch.Generator().manual_seed(0)
        stepped, _ = cell.step_fn(cell.state, cell.frame, cell.gt, generator=torch.Generator().manual_seed(0))
        state, _ = ttrain_cli.run_step(cell, cell.state, gen)
        assert state.step == 1
        results[white] = (stepped, state)
    stepped, state = results[False]
    torch.testing.assert_close(state.params.gaussians.opacity_logit, stepped.params.gaussians.opacity_logit,
                               rtol=0, atol=0)
    stepped, state = results[True]
    g = numpy_tree(stepped.params.gaussians)
    gauss = {k: torch.as_tensor(v) for k, v in g.items()}
    moments = {m: jG.GaussianParams(**{k[len(ttrain.GAUSS):]: jnp.asarray(v.numpy())
                                      for k, v in getattr(stepped.adam, m).items() if k.startswith(ttrain.GAUSS)})
               for m in ("mu", "nu", "count")}
    jstate = jtrain.TrainState(
        params=jrend.SceneParams(jG.GaussianParams(**{k: jnp.asarray(v) for k, v in g.items()}),
                                 None, None, None, None),
        adam=JAdamState(*(jrend.SceneParams(moments[m], None, None, None, None) for m in ("mu", "nu", "count"))),
        aux=None, step=jnp.asarray(1),
    )
    want = jtrain.make_reset_opacity_fn()(jstate)
    np.testing.assert_allclose(state.params.gaussians.opacity_logit.numpy(),
                               np.asarray(want.params.gaussians.opacity_logit), **TOL)
    assert float(gauss["opacity_logit"].max()) > float(np.asarray(want.params.gaussians.opacity_logit).max())
    for m in ("mu", "nu"):
        np.testing.assert_array_equal(getattr(state.adam, m)["gaussians.opacity_logit"].numpy(),
                                      np.asarray(getattr(want.adam, m).gaussians.opacity_logit))
