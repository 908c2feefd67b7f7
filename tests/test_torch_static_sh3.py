"""The port's train step on a static scene at SH degree 3 (3D Gaussian
splatting's recipe through the Colmap data type's objects: one
background cloud, no actors, no sky, no depth loss) against the JAX
package's step (Pallas in interpret mode) on the same inputs and against
the benchmark's plain reference (benchmark/reference/sh.py), on a small
seeded garden (benchmark/harness/orbit_scene.py at a toy size); binning
and the blend's work list past 2^24 instance slots.

Tolerances, and why: the port's tile path against the reference's
per-pixel compositing with float64 sums, as tests/test_rasterizer.py
holds the tile path to its oracle (the loss within rtol 1e-5, rgb
within 2e-5, gradients within 1e-4 of each leaf's largest |value|);
against the JAX step, tests/test_torch_train.py's (chip_smoke.grads_close
for gradients and moments, chip_smoke.params_close for the parameters
after the step: the two round a row's update into its float32 value in
their own order). Against the reference, Adam's update within 1e-3 of
its largest step (an update divides the first moment by the root of the
second, so it carries the gradient's relative error). Binning and the
work list past 2^24 slots: exact integers.
"""

import copy
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from benchmark.harness import orbit
from benchmark.harness.orbit_scene import make_scene, make_truth, toy_config
from benchmark.reference import sh as ref_sh
from benchmark.reference.render import precise
from street_gaussians_torch.models.renderer import render_frame
from street_gaussians_torch.ops.tile_raster2 import CHUNK, SEG, blend_plan_plain, plan_bounds, run_blocks
from street_gaussians_torch.train_lib import Draws, flatten_params, make_train_step
from chip_smoke import grads_close, params_close
from test_torch_runner import one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 2**31 + 19
GRAD_ATOL_SCALED = 1e-4
RGB_ATOL = 2e-5


@pytest.fixture(scope="module")
def garden():
    """The garden at 80 px wide, ~2,500 rows, 9 views; the program built
    as harness/orbit.py builds it, with a capacity the toy fills."""
    with open(os.path.join(REPO, "benchmark", "configs", "mipnerf360_garden.json")) as f:
        cfg = json.load(f)
    recipe = copy.deepcopy(cfg["recipe"])
    recipe["render"].update(instance_capacity=1 << 15, max_instance_capacity=1 << 15)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        scene = make_scene(toy_config(cfg["scene"], width=80, rows=2500, views=9), SEED, "cpu")
        views = scene.train_views[:2]
        truths = {i: make_truth(scene, scene.views[i], "cpu") for i in views}
        prog = orbit.build(scene, recipe, truths, "cpu")
    finally:
        torch.set_num_threads(n)
    return dict(scene=scene, prog=prog, recipe=recipe, views=views)


def _close(got, want, scale_atol, name):
    atol = scale_atol * max(float(want.abs().max()), 1e-30)
    torch.testing.assert_close(got, want, rtol=0, atol=atol, msg=lambda m: f"{name}: {m}")


def test_static_scene_is_the_colmap_shape(garden):
    """One model over the table, no actors, no pose data, no sky, SH
    degree 3 (15 rest coefficients a row), the recipe's static losses."""
    prog = garden["prog"]
    assert prog.table.num_actors == 0 and prog.pose_data is None
    p = prog.state.params
    assert p.actor_pose is None and p.sky is None
    assert p.gaussians.feat_rest.shape[1:] == (15, 3) and p.gaussians.feat_dc.shape[1:] == (1, 3)
    o = prog.cfg.optim
    assert (o.lambda_sky, o.lambda_reg, o.lambda_depth_lidar, o.lambda_dssim) == (0.0, 0.0, 0.0, 0.2)
    assert prog.state.step == 15_000 and not prog.cfg.data.white_background


def test_train_step_matches_the_reference(garden, one_thread):  # noqa: F811
    """A step at iteration 15,001 (every band on): the loss, the gradient
    of every leaf (feat_rest's bands 2-3 among them) and the Adam update
    against reference/sh.py's step on the same view."""
    scene, prog = garden["scene"], garden["prog"]
    i = garden["views"][0]
    state = prog.state
    step_fn = make_train_step(prog.cfg, prog.table, None, prog.opts_train)
    draws = Draws(torch.zeros(scene.capacity, dtype=torch.bool), None)
    scalars, _, grads, _, _ = step_fn.loss_and_grads(state, prog.frames[i], prog.truths[i], draws=draws)
    new, _ = step_fn(state, prog.frames[i], prog.truths[i], draws=draws)
    precise(True)
    ref_new, ref_loss, ref_grads = ref_sh.step(scene, ref_sh.initial_state(scene), garden["recipe"],
                                               scene.views[i], garden["prog"].truths[i].image)
    torch.testing.assert_close(scalars["loss"], ref_loss, rtol=1e-5, atol=0)
    for k, g in ref_grads.items():
        _close(grads[k], g, GRAD_ATOL_SCALED, k)
    hi = ref_grads["gaussians.feat_rest"][:, 3:]
    assert float(hi.abs().max()) > 0, "bands 2-3 get no gradient"
    _close(grads["gaussians.feat_rest"][:, 3:], hi, GRAD_ATOL_SCALED, "feat_rest bands 2-3")
    old = flatten_params(state.params)
    for k, v in flatten_params(new.params).items():
        _close(v - old[k], ref_new["params"][k] - old[k], 1e-3, f"update of {k}")
    assert new.step == ref_new["step"] == 15_001


@pytest.fixture(scope="module")
def jax_step(garden):
    """One JAX train step at iteration 15,001 on the toy garden: the JAX
    package's Colmap scene build (its static_readers._build_static_scene)
    from the inputs harness/orbit.build gives the port's, with the
    garden's rows, Adam state and ground truth (the table with the
    snapshot's capacity, as harness/orbit.build gives the port's)."""
    import jax
    import jax.numpy as jnp

    from benchmark.harness import program
    from street_gaussians_tpu import train_lib as jtrain
    from street_gaussians_tpu.config import default_config as j_default_config
    from street_gaussians_tpu.data.static_readers import _build_static_scene as j_build_static_scene
    from street_gaussians_tpu.models.renderer import SceneParams as JSceneParams
    from street_gaussians_tpu.runner import render_opts_from_cfg as j_render_opts

    scene, prog = garden["scene"], garden["prog"]
    i = garden["views"][0]
    jcfg = program.merge(j_default_config(), copy.deepcopy(garden["recipe"]))
    built = j_build_static_scene(jcfg, *orbit.loader_inputs(scene, prog.cfg))
    st = prog.state
    arr = lambda t, like: jnp.asarray(t.detach().numpy(), like.dtype)  # noqa: E731

    def gauss(leaves, like):
        return dataclasses.replace(like, **{f.name: arr(leaves[f"gaussians.{f.name}"], getattr(like, f.name))
                                            for f in dataclasses.fields(like)})

    g0 = built.params_init
    params = JSceneParams(gaussians=gauss(flatten_params(st.params), g0), actor_pose=None, sky=None,
                          color_correction=None, pose_correction=None)
    a0 = built.aux_init
    aux = dataclasses.replace(a0, **{f.name: arr(getattr(st.aux, f.name), getattr(a0, f.name))
                                     for f in dataclasses.fields(a0)})
    s0 = jtrain.init_train_state(params, aux)
    adam = s0.adam._replace(nu=dataclasses.replace(s0.adam.nu, gaussians=gauss(st.adam.nu, g0)),
                            count=dataclasses.replace(s0.adam.count, gaussians=gauss(st.adam.count, s0.adam.count.gaussians)))
    s0 = dataclasses.replace(s0, adam=adam, step=jnp.asarray(st.step, jnp.int32))
    view = sorted(built.train_views + built.test_views, key=lambda v: v.frame)[i]
    H, W = scene.H, scene.W
    gt = jtrain.GroundTruth(image=jnp.asarray(prog.truths[i].image.numpy()), mask=jnp.ones((H, W, 1), bool),
                            sky_mask=jnp.zeros((H, W, 1), bool), lidar_depth=jnp.zeros((H, W), jnp.float32),
                            obj_bound=jnp.zeros((H, W, 1), bool), sky_scale=jnp.ones(()))
    table = dataclasses.replace(built.table, slices=prog.table.slices.copy(), capacity=prog.table.capacity)
    step_fn = jtrain.make_train_step(jcfg, table, None, j_render_opts(jcfg, "train"), donate=False)
    s1, sc = step_fn(s0, view.frame_input, gt, jax.random.PRNGKey(0))
    flat = lambda tree: {f"gaussians.{k}": np.asarray(v) for k, v in dataclasses.asdict(tree.gaussians).items()}  # noqa: E731
    return dict(loss=float(sc["loss"]), mu=flat(s1.adam.mu), nu=flat(s1.adam.nu), count=flat(s1.adam.count),
                params=flat(s1.params), step=int(s1.step))


def test_train_step_matches_jax(garden, jax_step, one_thread):  # noqa: F811
    """The port's static SH-3 step against the JAX package's on the same
    inputs: the loss, every leaf's gradient (from JAX's first moment,
    mu = 0.1 g; feat_rest's bands 2-3 among them), both moments, the
    step counts and the Adam update."""
    scene, prog = garden["scene"], garden["prog"]
    i = garden["views"][0]
    state = prog.state
    step_fn = make_train_step(prog.cfg, prog.table, None, prog.opts_train)
    draws = Draws(torch.zeros(scene.capacity, dtype=torch.bool), None)
    scalars, _, grads, _, _ = step_fn.loss_and_grads(state, prog.frames[i], prog.truths[i], draws=draws)
    new, _ = step_fn(state, prog.frames[i], prog.truths[i], draws=draws)
    j = jax_step
    np.testing.assert_allclose(float(scalars["loss"].detach()), j["loss"], rtol=1e-5)
    alive = state.aux.alive.numpy()
    for k, g in grads.items():
        g = g.numpy() * alive.reshape((-1,) + (1,) * (g.dim() - 1))
        grads_close(g, j["mu"][k] / np.float32(0.1), f"grad {k}")
    hi = j["mu"]["gaussians.feat_rest"][:, 3:]
    assert np.abs(hi).max() > 0, "bands 2-3 get no gradient"
    grads_close(grads["gaussians.feat_rest"].numpy()[:, 3:] * alive[:, None, None], hi / np.float32(0.1),
                "grad feat_rest bands 2-3")
    for k, v in new.adam.nu.items():
        grads_close(new.adam.mu[k].numpy(), j["mu"][k], f"mu {k}")
        grads_close(np.sqrt(v.numpy()), np.sqrt(j["nu"][k]), f"nu {k}")
        np.testing.assert_array_equal(new.adam.count[k].numpy(), j["count"][k], err_msg=f"count {k}")
    lr = ref_sh.learning_rates(scene, garden["recipe"]["optim"], state.step)
    for k, v in flatten_params(new.params).items():
        params_close(v.numpy(), j["params"][k], j["mu"][k], lr[k], 1, f"params {k}")
    assert new.step == j["step"] == 15_001


@pytest.mark.parametrize("degree", [0, 1, 2, 3])
def test_render_follows_the_sh_ramp(garden, one_thread, degree):  # noqa: F811
    """The render at the ramp's iterations 0, 1,000, 2,000 and 3,000 (SH
    degree 0-3 on) against the reference's; each band changes the image."""
    scene, prog = garden["scene"], garden["prog"]
    i = garden["views"][1]
    st = prog.state
    p = {k: v.detach() for k, v in flatten_params(st.params).items()}
    with torch.no_grad():
        out = render_frame(st.params, st.aux, prog.table, None, prog.frames[i], 1000 * degree, opts=prog.opts_train)
        precise(True)
        ref = ref_sh.render(scene, p, scene.views[i], step=1000 * degree)
        below = ref_sh.render(scene, p, scene.views[i], step=1000 * (degree - 1)) if degree else None
    torch.testing.assert_close(out["rgb"], ref["rgb"], rtol=0, atol=RGB_ATOL)
    torch.testing.assert_close(out["acc"], ref["acc"], rtol=0, atol=RGB_ATOL)
    if below is not None:
        assert float((ref["rgb"] - below["rgb"]).abs().max()) > 10 * RGB_ATOL


def _full_grid_screen(n: int, gx: int, gy: int):
    """n Gaussians at increasing depth whose rects cover every tile of a
    gx x gy grid and whose alpha reaches every pixel (no corner cull)."""
    from street_gaussians_torch.ops.preprocess import GaussianScreenData

    i32 = torch.int32
    return GaussianScreenData(
        mean2d=torch.tensor([[8.0 * gx, 8.0 * gy]]).expand(n, 2).contiguous(),
        depth=1.0 + torch.arange(n, dtype=torch.float32) * 1e-3,
        conic=torch.tensor([[1e-6, 0.0, 1e-6]]).expand(n, 3).contiguous(), radius=torch.full((n,), 1e3),
        rgb=torch.zeros(n, 3), opacity=torch.full((n,), 0.9), valid=torch.ones(n, dtype=torch.bool),
        rect_min=torch.zeros(n, 2, dtype=i32), rect_max=torch.tensor([[gx, gy]], dtype=i32).expand(n, 2).contiguous(),
        tiles_touched=torch.full((n,), gx * gy, dtype=i32))


@pytest.fixture(scope="module")
def past_2_24():
    """The garden's 1297 x 840 grid (82 x 53 tiles) with 3,861 Gaussians
    over every tile: 16,779,906 instances, past 2^24, binned in a
    capacity of 2^24 + 2^16 slots."""
    from street_gaussians_torch.ops import binning

    gx, gy, n = 82, 53, 3861
    S = 2**24 + 2**16
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        b = binning.bin_gaussians_instances(_full_grid_screen(n, gx, gy), gx, gy, S, S)
    finally:
        torch.set_num_threads(n_threads)
    return dict(b=b, gx=gx, gy=gy, n=n, S=S)


def test_binning_past_2_24_instance_slots(past_2_24):
    """Every run start, count and Gaussian past slot 2^24 is exact and
    nothing overflows."""
    b, n, T = past_2_24["b"], past_2_24["n"], past_2_24["gx"] * past_2_24["gy"]
    assert int(b.num_instances) == n * T > 2**24 and int(b.overflow) == 0
    assert torch.equal(b.tile_start, torch.arange(T, dtype=torch.int32) * n)
    assert torch.equal(b.tile_count, torch.full((T,), n, dtype=torch.int32))
    last = int(b.tile_start[-1])
    assert last > 2**24 - n and torch.equal(b.inst_gauss[last:last + n], torch.arange(n, dtype=torch.int32))
    assert bool((b.inst_gauss[n * T:] == -1).all())


@pytest.mark.parametrize("seg_blocks", [1, SEG // CHUNK, 64])
def test_blend_work_list_past_2_24_instance_slots(past_2_24, seg_blocks):
    """The blend's work list (tile_raster2.blend_plan_plain, the kernels'
    build_plan in plain PyTorch) over those runs, with each run cut every
    block, every SEG / CHUNK blocks (the kernels') and never: within
    plan_bounds' sizes for the capacity's payload blocks, every tile's
    segments in a row and covering its run's blocks."""
    b, T = past_2_24["b"], past_2_24["gx"] * past_2_24["gy"]
    blocks = run_blocks(b.tile_start, b.tile_count)
    assert int(blocks.sum()) >= -(-int(b.num_instances) // CHUNK)
    plan = blend_plan_plain(b.tile_start, b.tile_count, seg_blocks)
    max_long, max_items = plan_bounds(-(-past_2_24["S"] // CHUNK), T, seg_blocks)
    nseg = (blocks + seg_blocks - 1) // seg_blocks
    assert plan["n_long"] == int(nseg[nseg > 1].sum()) <= max_long
    assert plan["n_items"] == plan["n_long"] + int((nseg == 1).sum()) <= max_items
    counted = torch.bincount(plan["item_tile"].to(torch.int64), minlength=T)
    assert torch.equal(counted, nseg)
    long_first = plan["tile_slot"][nseg > 1].to(torch.int64)
    assert torch.equal(plan["item_seg"][long_first], torch.zeros_like(long_first, dtype=torch.int32))
    assert bool((plan["tile_slot"][nseg == 1] == -1).all())
