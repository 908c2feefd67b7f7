"""Port parity for the training slice against the JAX package (Pallas in
interpret mode): the scatter-free VJPs (payload gather, sky lookup,
rows_from_models), the rasterizer's gradients, the losses, Adam,
densify / reset, and whole train steps with the JAX step's own random
draws fed to the port.

Tolerances, and why:
* VJPs and losses: rtol = atol = 1e-5. The same f32 operations; the
  JAX backward sorts with an unstable sort, so the order of the sums
  inside a segment differs from the port's stable one.
* Gradients of whole renders (chip_smoke.grads_close, which the card
  check shares): each leaf divided by its largest |JAX value|, atol 1e-4 (the JAX suite's own gate against its oracle,
  tests/test_rasterizer.py). The blend's prefix sums and the 256-pixel
  reductions run in another order, and so do SSIM's banded products,
  whose image gradient agrees to ~3e-8 absolute on values of ~1e-5 where
  its terms cancel: a row fed mostly by such pixels (colour rows behind
  the flat wall) carries that relative error. At most 3% of a leaf's
  rows may differ by up to 1e-3.
* Parameters after Adam (chip_smoke.params_close): eps is 1e-15, so a step moves a row by lr
  times a ratio of its gradients (the sign at the first step). A row
  whose gradient is within the comparison's noise of 0 can take either
  sign, and move by up to 2 lr per step. Rows whose first gradient is at
  least 1% of the leaf's largest must stay within 2% of lr per step
  (the ratios carry the gradients' relative error), except at most 1%
  of them; every row within 2 lr per step.
* Integers (overflow, alive rows, densify slots, step counts, denom):
  equal.
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import GRAD_ATOL_SCALED, grads_close, params_close
from street_gaussians_torch import convert
from street_gaussians_torch import train_lib as ttrain
from street_gaussians_torch.models import renderer as trend
from street_gaussians_torch.models import sky_cubemap as tsky
from street_gaussians_torch.ops import rasterize as trast
from street_gaussians_torch.ops.preprocess import preprocess_gaussians as t_preprocess
from street_gaussians_torch.optim import adam as tadam
from street_gaussians_torch.optim.densify import DensifyNoise
from street_gaussians_torch.utils import losses as tloss
from street_gaussians_torch.utils.camera import Camera
from street_gaussians_tpu import train_lib as jtrain
from street_gaussians_tpu.config import default_config
from street_gaussians_tpu.data.synthetic import make_synthetic_scene
from street_gaussians_tpu.models import renderer as jrend
from street_gaussians_tpu.models import sky_cubemap as jsky
from street_gaussians_tpu.models.sky_cubemap import SkyParams
from street_gaussians_tpu.optim import adam as jadam
from street_gaussians_tpu.ops.rasterize import build_payload_blocks as j_build_payload
from street_gaussians_tpu.utils import losses as jloss

TOL = dict(rtol=1e-5, atol=1e-5)
START_STEP = 2500  # SH degree 2 active, densify statistics collected


def numpy_tree(obj):
    """A JAX dataclass / NamedTuple as nested dicts of numpy arrays."""
    if obj is None or isinstance(obj, (bool, int, float, str, list)):
        return obj
    if dataclasses.is_dataclass(obj):
        return {f.name: numpy_tree(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    return np.asarray(obj)


def jax_flat(params):
    """The JAX SceneParams under the port's flat names."""
    return {
        f"{g}.{k}": np.asarray(v)
        for g, sub in numpy_tree(params).items() if sub is not None
        for k, v in sub.items()
    }


def port_state(js):
    adam = {k: numpy_tree(getattr(js.adam, k)) for k in ("mu", "nu", "count")}
    return convert.train_state_from_numpy(
        numpy_tree(js.params), adam, numpy_tree(js.aux), js.step, "cpu"
    )


def assert_scaled(got, want, atol, name):
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(np.asarray(got) / scale, want / scale, rtol=0, atol=atol, err_msg=name)


# ---------------------------------------------------------------- VJPs


def test_payload_vjp_matches_jax():
    """build_payload_blocks' gradient: dropped slots (-1), repeated ids,
    a capacity that is not a block multiple."""
    rng = np.random.default_rng(0)
    N, S, C = 200, 1000, 16
    src = rng.normal(size=(N, C)).astype(np.float32)
    inst = rng.integers(0, N, S).astype(np.int32)
    inst[rng.uniform(size=S) < 0.2] = -1
    fwd, vjp = jax.vjp(lambda s: j_build_payload(s, jnp.asarray(inst), True), jnp.asarray(src))
    d_blocks = rng.normal(size=fwd.shape).astype(np.float32)
    (want,) = vjp(jnp.asarray(d_blocks))
    t_src = torch.as_tensor(src).requires_grad_(True)
    blocks = trast.build_payload_blocks(t_src, torch.as_tensor(inst))
    np.testing.assert_array_equal(blocks.detach().numpy(), np.asarray(fwd))
    blocks.backward(torch.as_tensor(d_blocks))
    np.testing.assert_allclose(t_src.grad.numpy(), np.asarray(want), **TOL)


def test_sky_lookup_vjp_matches_jax():
    """The cubemap gradient of the 4-tap lookup, directions covering all
    faces and the clamped face borders."""
    rng = np.random.default_rng(1)
    R = 8
    cm = rng.uniform(0, 1, (3, 6 * R * R)).astype(np.float32)
    dirs = rng.normal(size=(12, 14, 3)).astype(np.float32)
    dirs[0, :, 0] = 1e3  # on the +x face's center line
    fwd, vjp = jax.vjp(lambda c: jsky.sample_cubemap(c, jnp.asarray(dirs), True), jnp.asarray(cm))
    g = rng.normal(size=fwd.shape).astype(np.float32)
    (want,) = vjp(jnp.asarray(g))
    t_cm = torch.as_tensor(cm).requires_grad_(True)
    out = tsky.sample_cubemap(t_cm, torch.as_tensor(dirs))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(fwd), **TOL)
    out.backward(torch.as_tensor(g))
    np.testing.assert_allclose(t_cm.grad.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("covered", [True, False])
def test_rows_from_models_vjp_matches_jax(covered):
    """Slices covering the rows (slice sums) and a row subset (one-hot)."""
    rng = np.random.default_rng(2)
    slices = ((0, 5), (5, 9), (9, 16))
    mid = np.repeat(np.arange(3), [5, 4, 7]).astype(np.int32)
    if not covered:
        mid = mid[3:12]
    pm = rng.normal(size=(3, 4)).astype(np.float32)
    g = rng.normal(size=(mid.size, 4)).astype(np.float32)
    _, vjp = jax.vjp(lambda p: jrend.rows_from_models(p, jnp.asarray(mid), slices), jnp.asarray(pm))
    (want,) = vjp(jnp.asarray(g))
    t_pm = torch.as_tensor(pm).requires_grad_(True)
    out = trend.rows_from_models(t_pm, torch.as_tensor(mid).long(), slices)
    np.testing.assert_array_equal(out.detach().numpy(), pm[mid])
    out.backward(torch.as_tensor(g))
    np.testing.assert_allclose(t_pm.grad.numpy(), np.asarray(want), **TOL)


def test_rasterizer_gradients_match_jax():
    """tests/test_rasterizer.py's gradient-parity scene (60 Gaussians,
    32x32): preprocess + rasterize through the port's autograd path
    against JAX autodiff of the JAX rasterizer."""
    from test_rasterizer import CFG, make_scene, run_preprocess
    from street_gaussians_tpu.ops.rasterize import rasterize as j_rasterize

    cam, means, scales, quats, opacity, shs = make_scene(jax.random.PRNGKey(4), 60, H=32, W=32)
    bg = np.array([0.5, 0.5, 0.5], np.float32)
    target = np.asarray(jax.random.uniform(jax.random.PRNGKey(5), (32, 32, 3)))

    def head(out, xp, tgt):
        return xp.mean((out["rgb"] - tgt) ** 2) + 0.1 * xp.mean(out["depth"]) + 0.05 * xp.mean(out["acc"])

    def j_loss(*args):
        screen = run_preprocess(cam, *args)
        return head(j_rasterize(screen, 32, 32, jnp.asarray(bg), config=CFG), jnp, jnp.asarray(target))

    args = (means, scales, quats, opacity, shs)
    want_val, want = jax.value_and_grad(j_loss, argnums=(0, 1, 2, 3, 4))(*args)

    t = lambda a: torch.as_tensor(np.array(a))  # noqa: E731
    tcam = Camera(w2c=t(cam.w2c), proj=t(cam.proj), cam_center=t(cam.cam_center), K=t(cam.K), H=32, W=32)
    targs = [t(a).requires_grad_(True) for a in args]
    screen = t_preprocess(
        *targs, tcam.w2c, tcam.full_proj, tcam.cam_center, 32, 32, tcam.focal_x, tcam.focal_y,
        tcam.tan_fovx, tcam.tan_fovy, sh_degree=2,
    )
    cfg = trast.RasterizeConfig(tile_capacity=CFG.tile_capacity, instance_capacity=CFG.instance_capacity)
    loss = head(trast.rasterize(screen, 32, 32, t(bg), config=cfg), torch, t(target))
    loss.backward()
    np.testing.assert_allclose(float(loss), float(want_val), rtol=1e-5)
    for name, a, w in zip(("means", "scales", "quats", "opacity", "shs"), targs, want):
        assert_scaled(a.grad.numpy(), np.asarray(w), GRAD_ATOL_SCALED, name)


# ---------------------------------------------------------------- losses


def _images(seed, H=20, W=24):
    rng = np.random.default_rng(seed)
    pred = rng.uniform(0, 1, (H, W, 3)).astype(np.float32)
    gt = np.clip(pred + rng.normal(0, 0.1, pred.shape), 0, 1).astype(np.float32)
    gt[:5, :6] = 0.5  # a flat patch: the variance guard's case
    pred[:5, :6] = 0.5
    mask = rng.uniform(size=(H, W, 1)) < 0.8
    return pred, gt, mask


def test_ssim_value_and_gradient_match_jax():
    pred, gt, mask = _images(0)
    f = lambda p: jloss.ssim(p, jnp.asarray(gt), mask=jnp.asarray(mask))  # noqa: E731
    want, want_g = jax.value_and_grad(f)(jnp.asarray(pred))
    p = torch.as_tensor(pred).requires_grad_(True)
    got = tloss.ssim(p, torch.as_tensor(gt), mask=torch.as_tensor(mask))
    got.backward()
    np.testing.assert_allclose(float(got), float(want), **TOL)
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(want_g), **TOL)
    for fn in ("l1_loss", "l2_loss", "psnr"):
        np.testing.assert_allclose(
            float(getattr(tloss, fn)(torch.as_tensor(pred), torch.as_tensor(gt), torch.as_tensor(mask))),
            float(getattr(jloss, fn)(jnp.asarray(pred), jnp.asarray(gt), jnp.asarray(mask))), **TOL,
        )
    for fn in ("binary_cross_entropy", "entropy_loss"):
        np.testing.assert_allclose(
            float(getattr(tloss, fn)(torch.as_tensor(pred), torch.as_tensor(gt))),
            float(getattr(jloss, fn)(jnp.asarray(pred), jnp.asarray(gt))), **TOL,
        )


def test_compute_losses_and_trimmed_depth_match_jax():
    """The bench loss stack (L1 + DSSIM, sky BCE, trimmed LiDAR depth)
    on a fake render: values and gradients in rgb, acc and depth.
    Pixels with acc 0 and 1 reach the clamps; masked-out LiDAR pixels
    and repeated errors exercise the bisection's threshold."""
    pred, gt_img, mask = _images(1)
    H, W = pred.shape[:2]
    rng = np.random.default_rng(3)
    acc = rng.uniform(0, 1, (H, W)).astype(np.float32)
    acc[0, :4] = [0.0, 1.0, 5e-3, 0.5]
    depth = (acc * rng.uniform(5, 12, (H, W))).astype(np.float32)
    depth[1, :6] = acc[1, :6] * 10.0  # zero errors
    lidar = np.where(rng.uniform(size=(H, W)) < 0.9, 8.0, 0.0).astype(np.float32)
    sky_mask = rng.uniform(size=(H, W, 1)) < 0.3
    cfg = default_config()
    cfg.optim.lambda_sky = 0.05
    cfg.optim.lambda_depth_lidar = 0.1
    jgt = jtrain.GroundTruth(
        image=jnp.asarray(gt_img), mask=jnp.asarray(mask), sky_mask=jnp.asarray(sky_mask),
        lidar_depth=jnp.asarray(lidar), obj_bound=jnp.zeros((H, W, 1), bool), sky_scale=jnp.asarray(1.5),
    )

    def j_loss(rgb, a, d):
        return jtrain.compute_losses(
            {"rgb": rgb, "acc": a, "depth": d}, None, jgt, jrend.SceneParams(None, None, None, None, None),
            cfg, 0, jnp.asarray(1.0),
        )

    (want, want_sc), want_g = jax.value_and_grad(j_loss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(pred), jnp.asarray(acc), jnp.asarray(depth)
    )
    tgt = convert.ground_truth_from_numpy(numpy_tree(jgt), "cpu")
    ins = [torch.as_tensor(x).requires_grad_(True) for x in (pred, acc, depth)]
    got, got_sc = ttrain.compute_losses(
        {"rgb": ins[0], "acc": ins[1], "depth": ins[2]}, tgt,
        trend.SceneParams(None, None, None, None, None), cfg, 0,
    )
    got.backward()
    assert set(got_sc) == set(want_sc)
    for k in want_sc:
        np.testing.assert_allclose(float(got_sc[k]), float(want_sc[k]), err_msg=k, **TOL)
    for name, a, w in zip(("rgb", "acc", "depth"), ins, want_g):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(w), err_msg=name, **TOL)
    # the threshold is exactly the sort's k-th smallest error
    err = np.abs(depth / np.maximum(acc, 1e-2) - lidar)
    m = (lidar > 0) & mask[..., 0]
    k = max(int(np.floor(0.95 * m.sum())), 1)
    thr = np.sort(err[m])[k - 1]
    keep = (err <= thr) & m
    np.testing.assert_allclose(float(got_sc["lidar_depth_loss"]), err[keep].sum() / keep.sum(), rtol=1e-5)


def test_regularizers_match_jax():
    """scale_flatten_loss, box_reg_loss and the two correction
    regularizers (values and gradients), and sh_band_mask, on a scene
    with actors, dead rows and identity corrections (|x| at 0)."""
    from street_gaussians_torch.models import corrections as tcorr
    from street_gaussians_torch.models import gaussians as tg
    from street_gaussians_tpu.models import corrections as jcorr
    from street_gaussians_tpu.models import gaussians as jg

    scene = make_synthetic_scene(num_bkgd=100, num_actors=2, H=32, W=48, seed=5, round_to=128)
    rng = np.random.default_rng(9)
    C = scene.table.capacity
    log_scale = (np.asarray(scene.params_init.log_scale) + rng.uniform(-1, 1, (C, 3))).astype(np.float32)
    jgp = dataclasses.replace(scene.params_init, log_scale=jnp.asarray(log_scale))
    p, aux, table, _ = convert.scene_from_numpy(
        {"gaussians": numpy_tree(jgp)}, numpy_tree(scene.aux), numpy_tree(scene.table), None, "cpu"
    )
    ls = p.gaussians.log_scale.requires_grad_(True)
    for jfn, tfn in (
        (lambda x: jg.scale_flatten_loss(dataclasses.replace(jgp, log_scale=x), scene.aux.alive),
         lambda x: tg.scale_flatten_loss(dataclasses.replace(p.gaussians, log_scale=x), aux.alive)),
        (lambda x: jg.box_reg_loss(dataclasses.replace(jgp, log_scale=x), scene.aux, scene.table),
         lambda x: tg.box_reg_loss(dataclasses.replace(p.gaussians, log_scale=x), aux, table)),
    ):
        want, want_g = jax.value_and_grad(jfn)(jnp.asarray(log_scale))
        got = tfn(ls)
        (got_g,) = torch.autograd.grad(got, ls)
        np.testing.assert_allclose(float(got), float(want), **TOL)
        np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), **TOL)
    for active in range(4):
        np.testing.assert_array_equal(tg.sh_band_mask(active, 3).numpy(), np.asarray(jg.sh_band_mask(active, 3)))

    n = 4
    affine = np.tile(np.eye(4, dtype=np.float32)[:3], (n, 1, 1))
    affine[1] += rng.normal(0, 0.1, (3, 4)).astype(np.float32)
    rots = np.tile(np.array([1, 0, 0, 0], np.float32), (n, 1))
    rots[2] += rng.normal(0, 0.1, 4).astype(np.float32)
    trans = np.zeros((n, 3), np.float32)
    trans[3] = [0.1, -0.2, 0.0]
    for idx in (0, 1):
        f = lambda a: jcorr.color_correction_reg(jcorr.ColorCorrectionParams(a, a), idx)  # noqa: E731
        want, want_g = jax.value_and_grad(f)(jnp.asarray(affine))
        a = torch.as_tensor(affine).requires_grad_(True)
        got = tcorr.color_correction_reg(tcorr.ColorCorrectionParams(a, a), idx)
        got.backward()
        np.testing.assert_allclose(float(got), float(want), **TOL)
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(want_g), **TOL)
    f = lambda r, t: jcorr.pose_correction_reg(jcorr.PoseCorrectionParams(t, r))  # noqa: E731
    want, want_g = jax.value_and_grad(f, argnums=(0, 1))(jnp.asarray(rots), jnp.asarray(trans))
    r, t = (torch.as_tensor(x).requires_grad_(True) for x in (rots, trans))
    got = tcorr.pose_correction_reg(tcorr.PoseCorrectionParams(t, r))
    got.backward()
    np.testing.assert_allclose(float(got), float(want), **TOL)
    for a, w in ((r, want_g[0]), (t, want_g[1])):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(w), **TOL)


# ---------------------------------------------------------------- Adam


def test_adam_with_masks_and_late_rows_matches_jax():
    """Three steps over a row-counted leaf (rows masked off, some rows
    entering only at the third step) and a scalar-counted leaf."""
    rng = np.random.default_rng(4)
    N = 40
    p = {"a": rng.normal(size=(N, 3)).astype(np.float32), "b": rng.normal(size=(3, 4)).astype(np.float32)}
    jstate = jadam.adam_init({k: jnp.asarray(v) for k, v in p.items()}, {"a": True, "b": False})
    tstate = tadam.adam_init({k: torch.as_tensor(v) for k, v in p.items()}, row_counted={"a"})
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.as_tensor(v) for k, v in p.items()}
    lr_a = rng.uniform(1e-3, 1e-2, N).astype(np.float32)
    for step in range(3):
        g = {k: rng.normal(size=v.shape).astype(np.float32) for k, v in p.items()}
        g["a"][:3] = 0.0  # zero gradients keep their rows still
        mask = rng.uniform(size=N) < 0.7
        mask[-5:] = step == 2  # late-entering rows
        jp, jstate = jadam.adam_update(
            jp, {k: jnp.asarray(v) for k, v in g.items()}, jstate,
            {"a": jnp.asarray(lr_a), "b": 0.05}, {"a": jnp.asarray(mask), "b": jnp.ones(())},
        )
        tp, tstate = tadam.adam_update(
            tp, {k: torch.as_tensor(v) for k, v in g.items()}, tstate,
            {"a": torch.as_tensor(lr_a), "b": 0.05}, {"a": torch.as_tensor(mask)},
        )
    for k in p:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-7, err_msg=k)
        np.testing.assert_allclose(tstate.mu[k].numpy(), np.asarray(jstate.mu[k]), **TOL)
        np.testing.assert_allclose(tstate.nu[k].numpy(), np.asarray(jstate.nu[k]), **TOL)
        np.testing.assert_array_equal(tstate.count[k].numpy(), np.asarray(jstate.count[k]))
    assert tstate.count["a"][-1] == 1 and tstate.count["b"] == 3


# ---------------------------------------------------------------- train steps


@pytest.fixture(scope="module")
def step_run():
    """The JAX train step (Pallas in interpret mode) on a 64x96 scene
    with 2 actors (symmetry flip at 0.5), a random 16-texel sky and the
    bench's loss weights, 3 steps from step 2500; each step's draws,
    computed as the JAX renderer draws them, for the port."""
    scene = make_synthetic_scene(num_bkgd=300, num_actors=2, H=64, W=96, seed=3, round_to=128)
    M = scene.table.num_models
    table = dataclasses.replace(scene.table, flip_prob=jnp.asarray([0.0] + [0.5] * (M - 1), jnp.float32))
    rng = np.random.default_rng(6)
    # random rotations and anisotropic scales: with the synthetic scene's
    # identity rotations and isotropic scales the rotation gradient is 0
    # up to rounding, and its sign (which Adam follows) is noise
    g0 = scene.params_init
    C = scene.table.capacity
    rot = rng.normal(size=(C, 4)).astype(np.float32)
    alive0 = np.asarray(scene.aux.alive)[:, None]
    log_scale = np.asarray(g0.log_scale) + rng.uniform(-0.4, 0.4, (C, 3)).astype(np.float32) * alive0
    gauss = dataclasses.replace(
        g0, rot=jnp.asarray(np.where(alive0, rot, np.asarray(g0.rot))), log_scale=jnp.asarray(log_scale)
    )
    params = jrend.SceneParams(
        gaussians=gauss,
        actor_pose=scene.pose_params_init,
        sky=SkyParams(cubemap=jnp.asarray(rng.uniform(0.2, 0.8, (3, 6 * 16 * 16)).astype(np.float32))),
        color_correction=None,
        pose_correction=None,
    )
    cap = 2**14
    jopts = jrend.RenderOptions(mode="train", tile_capacity=cap, instance_capacity=cap, interpret=True)
    frame = scene.frames[2]
    H, W = frame.cam.H, frame.cam.W
    img = np.asarray(jrend.render_frame(
        params, scene.aux, table, scene.pose_data, frame, step=jnp.asarray(START_STEP),
        opts=dataclasses.replace(jopts, mode="eval"),
    )["rgb"])
    img = np.clip(img + rng.normal(0, 0.05, img.shape), 0, 1).astype(np.float32)
    gt = jtrain.GroundTruth(
        image=jnp.asarray(img), mask=jnp.ones((H, W, 1), bool),
        sky_mask=jnp.asarray(rng.uniform(size=(H, W, 1)) < 0.3),
        lidar_depth=jnp.full((H, W), 8.0, jnp.float32), obj_bound=jnp.zeros((H, W, 1), bool),
        sky_scale=jnp.ones(()),
    )
    cfg = default_config()
    cfg.optim.lambda_sky = 0.05
    cfg.optim.lambda_depth_lidar = 0.1
    state = dataclasses.replace(
        jtrain.init_train_state(params, scene.aux), step=jnp.asarray(START_STEP, jnp.int32)
    )
    step_fn = jtrain.make_train_step(cfg, table, scene.pose_data, jopts, donate=False)
    states, scalars, draws = [state], [], []
    for i in range(3):
        key = jax.random.PRNGKey(10 + i)
        k_render, _ = jax.random.split(key)
        flip = np.asarray(jax.random.uniform(k_render, (table.capacity,))) < np.asarray(
            table.flip_prob)[np.asarray(scene.aux.model_id)]
        jitter = np.asarray(jax.random.uniform(jax.random.fold_in(k_render, 1), (H, W, 2))) - 0.5
        draws.append(ttrain.Draws(torch.as_tensor(flip), torch.as_tensor(jitter.astype(np.float32))))
        s, sc = step_fn(copy.deepcopy(states[-1]), frame, gt, key)
        states.append(s)
        scalars.append({k: np.asarray(v) for k, v in sc.items()})
    assert any(d.flip.any() for d in draws)

    p, aux, ttable, pose, tframe = (
        *convert.scene_from_numpy(numpy_tree(params), numpy_tree(scene.aux), numpy_tree(table),
                                  numpy_tree(scene.pose_data), "cpu"),
        convert.frame_from_numpy(numpy_tree(frame), "cpu"),
    )
    topts = trend.RenderOptions(mode="train", tile_capacity=cap, instance_capacity=cap)
    port = dict(
        step_fn=ttrain.make_train_step(cfg, ttable, pose, topts),
        densify_fn=ttrain.make_densify_fn(cfg, ttable),
        frame=tframe, gt=convert.ground_truth_from_numpy(numpy_tree(gt), "cpu"),
    )
    return dict(states=states, scalars=scalars, draws=draws, cfg=cfg, table=table, port=port)


def _lr_bound(cfg, name):
    """The largest learning rate a leaf can see at these steps."""
    o = cfg.optim
    return {
        "gaussians.xyz": o.position_lr_init * 12.0, "gaussians.feat_dc": o.feature_lr,
        "gaussians.feat_rest": o.feature_lr / 20.0, "gaussians.log_scale": o.scaling_lr,
        "gaussians.rot": o.rotation_lr, "gaussians.opacity_logit": o.opacity_lr,
        "sky.cubemap": o.sky_cube_map_lr_init,
    }.get(name, 0.0)


def test_one_train_step_matches_jax(step_run):
    """Step 1: loss and every scalar, each leaf's gradient (from the
    JAX step's first Adam moment, mu = 0.1 g), the updated parameters,
    both moments, the step counts and the densification statistics."""
    r = step_run
    pstep = r["port"]["step_fn"]
    state0 = port_state(r["states"][0])
    got_sc, out, grads, _, _ = pstep.loss_and_grads(state0, r["port"]["frame"], r["port"]["gt"], draws=r["draws"][0])
    s1, sc = pstep(state0, r["port"]["frame"], r["port"]["gt"], draws=r["draws"][0])
    want_sc = r["scalars"][0]
    # the port's step adds its instance counters (utils/trace.py's table)
    assert set(want_sc) == set(sc) - {"num_instances", "instance_fill"}
    assert float(sc["num_instances"]) == int(out["num_instances"]) > 0
    for k, v in want_sc.items():
        if k.startswith("overflow") or k == "num_alive":
            assert int(sc[k]) == int(v), k
        else:
            np.testing.assert_allclose(float(sc[k]), float(v), rtol=1e-5, atol=1e-6, err_msg=k)
    js = r["states"][1]
    want_mu = jax_flat(js.adam.mu)
    alive = np.asarray(js.aux.alive)
    for k, g in grads.items():
        g = g.numpy()
        if k.startswith(ttrain.GAUSS):
            g = g * alive.reshape((-1,) + (1,) * (g.ndim - 1))
        grads_close(g, want_mu[k] / np.float32(0.1), f"grad {k}")
    _assert_state_close(s1, js, r, steps=1)


def test_three_train_steps_match_jax(step_run):
    r = step_run
    pstep = r["port"]["step_fn"]
    s = port_state(r["states"][0])
    for i in range(3):
        s, sc = pstep(s, r["port"]["frame"], r["port"]["gt"], draws=r["draws"][i])
        np.testing.assert_allclose(float(sc["loss"]), float(r["scalars"][i]["loss"]), rtol=1e-5)
        assert int(sc["overflow"]) == 0
    assert s.step == START_STEP + 3
    _assert_state_close(s, r["states"][3], r, steps=3)


def _assert_state_close(s, js, r, steps):
    want_p = jax_flat(js.params)
    got_p = ttrain.flatten_params(s.params)
    g1 = jax_flat(r["states"][1].adam.mu)  # 0.1 x the first step's gradients
    assert set(got_p) == set(want_p)
    for k in want_p:
        params_close(got_p[k].numpy(), want_p[k], g1[k], _lr_bound(r["cfg"], k), steps, k)
    for mom in ("mu", "nu"):
        want = jax_flat(getattr(js.adam, mom))
        for k, v in getattr(s.adam, mom).items():
            if mom == "nu":  # squared gradients: compare their roots
                v, want[k] = np.sqrt(v.numpy()), np.sqrt(want[k])
            grads_close(np.asarray(v), want[k], f"{mom} {k}")
    want_c = jax_flat(js.adam.count)
    for k, v in s.adam.count.items():
        np.testing.assert_array_equal(v.numpy(), want_c[k], err_msg=f"count {k}")
    np.testing.assert_array_equal(s.aux.alive.numpy(), np.asarray(js.aux.alive))
    np.testing.assert_array_equal(s.aux.denom.numpy(), np.asarray(js.aux.denom))
    np.testing.assert_array_equal(s.aux.max_radii.numpy(), np.asarray(js.aux.max_radii))
    for c in range(2):
        grads_close(s.aux.grad_accum[:, c].numpy(), np.asarray(js.aux.grad_accum)[:, c],
                           f"grad_accum[:, {c}]")


def test_densify_and_reset_match_jax(step_run):
    """One densify round on the JAX state after three steps, with a low
    threshold so that rows clone and split, the JAX draws injected, big
    points pruned: alive rows and slot assignment equal, candidates
    close; then one opacity reset."""
    r = step_run
    cfg = copy.deepcopy(r["cfg"])
    st = r["states"][3]
    table = r["table"]
    alive = np.asarray(st.aux.alive)
    grads = np.asarray(st.aux.grad_accum)[:, 0] / np.maximum(np.asarray(st.aux.denom), 1)
    cfg.optim.densify_grad_threshold = float(np.quantile(grads[alive], 0.8))
    # half of the selected rows small enough to clone
    ratio = np.exp(np.asarray(st.params.gaussians.log_scale)).max(axis=1) / np.asarray(
        table.extent)[np.asarray(st.aux.model_id)]
    cfg.optim.percent_dense = float(np.median(ratio[alive & (grads >= cfg.optim.densify_grad_threshold)]))
    C = table.capacity
    key = jax.random.PRNGKey(21)
    k1, k_box = jax.random.split(key)
    _, k_s1, k_s2 = jax.random.split(k1, 3)
    noise = DensifyNoise(*(torch.as_tensor(np.asarray(jax.random.normal(k, shape))) for k, shape in (
        (k_box, (C, 2, 3)), (k_s1, (C, 3)), (k_s2, (C, 3)))))
    js, jdiag = jtrain.make_densify_fn(cfg, table)(copy.deepcopy(r["states"][3]), key, jnp.asarray(True))
    pfn = ttrain.make_densify_fn(cfg, _port_table(r))
    s, diag = pfn(port_state(r["states"][3]), None, True, noise=noise)
    for k, v in jdiag.items():
        assert int(diag[k]) == int(v), k
    assert int(jdiag["points_clone"]) > 0 and int(jdiag["points_split"]) > 0
    np.testing.assert_array_equal(s.aux.alive.numpy(), np.asarray(js.aux.alive))
    want_p = jax_flat(js.params)
    for k, v in ttrain.flatten_params(s.params).items():
        np.testing.assert_allclose(v.numpy(), want_p[k], rtol=1e-6, atol=1e-6, err_msg=k)
    for mom in ("mu", "nu", "count"):
        want = jax_flat(getattr(js.adam, mom))
        for k, v in getattr(s.adam, mom).items():
            np.testing.assert_allclose(v.numpy(), want[k], rtol=1e-6, atol=0, err_msg=f"{mom} {k}")
    for k in ("grad_accum", "denom", "max_radii"):
        assert (getattr(s.aux, k) == 0).all()

    js = jtrain.make_reset_opacity_fn()(js)
    s = ttrain.make_reset_opacity_fn()(s)
    np.testing.assert_allclose(
        s.params.gaussians.opacity_logit.numpy(), np.asarray(js.params.gaussians.opacity_logit), **TOL
    )
    assert (s.adam.mu["gaussians.opacity_logit"] == 0).all()
    np.testing.assert_array_equal(
        s.adam.count["gaussians.opacity_logit"].numpy(), np.asarray(js.adam.count.gaussians.opacity_logit)
    )


def _port_table(r):
    return convert.scene_from_numpy(
        numpy_tree(r["states"][0].params), numpy_tree(r["states"][0].aux), numpy_tree(r["table"]), None, "cpu"
    )[2]
