"""The port's per-pixel oracle (ops/reference_rasterizer.py,
ops/rasterize.render_reference) and single-cloud renderer
(models/simple_renderer.render_gaussians) against the JAX package's, and
the port's tile path against its own oracle (the cases of
tests/test_rasterizer.py::TestTileVsOracle and
tests/test_simple_renderer.py).

Inputs are drawn by numpy (chip_smoke.oracle_case: make_scene's
distributions) and handed to both packages. Tolerances, and why:
* oracle against oracle on JAX's own screen: the same f32 operations in
  the same order; exp may round differently in XLA and torch, so 1e-6
  absolute on the features and T (measured: within 7.2e-7, on values up
  to the depth's ~6);
* the whole oracle path (each package's preprocess, then its oracle):
  1e-5 absolute, the preprocess's matrix products rounding apart
  (measured: within 9.6e-7); the gradients of the gradient-parity loss
  through both, each leaf scaled by its largest |JAX value|, 1e-5
  (measured: within 3.9e-7), the loss within rtol 1e-6 (measured: 1.0e-7);
* the tile path against the oracle: tests/test_rasterizer.py's own
  tolerances (rgb and acc 2e-5, depth 2e-4; 5e-5 at opacities up to
  0.999; extra channels 2e-4; gradients 1e-4 scaled, loss rtol 1e-5);
* render_gaussians against JAX's (Pallas in interpret mode): 1e-5 on
  rgb, depth, acc and T, as tests/test_torch_render.py; radii,
  visibility and the binning counters equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import oracle_case
from street_gaussians_torch.models.simple_renderer import render_gaussians as t_render_gaussians
from street_gaussians_torch.ops import rasterize as trast
from street_gaussians_torch.ops.preprocess import GaussianScreenData as TScreen
from street_gaussians_torch.ops.preprocess import preprocess_gaussians as t_preprocess
from street_gaussians_torch.ops.reference_rasterizer import reference_render as t_reference_render
from street_gaussians_tpu.models.simple_renderer import render_gaussians as j_render_gaussians
from street_gaussians_tpu.ops.rasterize import RasterizeConfig as JConfig
from street_gaussians_tpu.ops.rasterize import render_reference as j_render_reference
from street_gaussians_tpu.ops.preprocess import preprocess_gaussians as j_preprocess
from street_gaussians_tpu.ops.reference_rasterizer import reference_render as j_reference_render
from street_gaussians_tpu.utils.camera import make_camera as j_make_camera
from test_torch_runner import one_thread  # noqa: F401

ORACLE_ATOL = 1e-6
PATH_ATOL = 1e-5
GRAD_ATOL_SCALED = 1e-5
TILE_GRAD_ATOL_SCALED = 1e-4
RENDER_TOL = dict(rtol=1e-5, atol=1e-5)
T_CFG = trast.RasterizeConfig(tile_capacity=256, instance_capacity=2**14)

# name: (seed, n, H, W, opacity_max, extra channels); the scenes of
# TestTileVsOracle (tests/test_rasterizer.py:123-160)
SCENES = {
    "n50": (0, 50, 48, 64, 0.9, 0),
    "n400": (0, 400, 48, 64, 0.9, 0),
    "opaque": (1, 300, 48, 64, 0.999, 0),
    "semantic": (2, 80, 48, 64, 0.9, 5),
    "gradient": (4, 60, 32, 32, 0.9, 0),
}
BG = {"n50": (0.1, 0.2, 0.3), "n400": (0.1, 0.2, 0.3), "gradient": (0.5, 0.5, 0.5)}


def scene(name):
    """(port cam, port tensors, JAX cam, numpy arrays, extra [n, S] or None)."""
    seed, n, H, W, op_max, S = SCENES[name]
    cam, *g = oracle_case(seed, n, H, W, "cpu", opacity_max=op_max)
    arrays = [x.numpy() for x in g]
    jcam = j_make_camera(cam.K.numpy(), np.eye(4, dtype=np.float32), H, W)
    extra = np.random.default_rng(seed + 100).normal(size=(n, S)).astype(np.float32) if S else None
    return cam, g, jcam, arrays, extra


def t_screen(cam, means, scales, quats, opacity, shs, **kw):
    return t_preprocess(means, scales, quats, opacity, shs, cam.w2c, cam.full_proj, cam.cam_center, cam.H,
                        cam.W, cam.focal_x, cam.focal_y, cam.tan_fovx, cam.tan_fovy, sh_degree=2, **kw)


def j_screen(cam, means, scales, quats, opacity, shs, **kw):
    return j_preprocess(means, scales, quats, opacity, shs, cam.w2c, cam.full_proj, cam.cam_center, cam.H,
                        cam.W, cam.focal_x, cam.focal_y, cam.tan_fovx, cam.tan_fovy, sh_degree=2, **kw)


def to_torch_screen(js) -> TScreen:
    return TScreen(*(torch.as_tensor(np.asarray(v)) for v in js))


def gradient_loss(target, depth_w=0.1, acc_w=0.05):
    """tests/test_rasterizer.py::test_gradient_parity's loss (every head)."""
    def loss(out):
        return ((out["rgb"] - target) ** 2).mean() + depth_w * out["depth"].mean() + acc_w * out["acc"].mean()
    return loss


GRAD_TARGET = np.random.default_rng(5).uniform(size=(32, 32, 3)).astype(np.float32)
NAMES = ("means", "scales", "quats", "opacity", "shs")


@pytest.fixture(scope="module")
def jax_refs():
    """JAX's oracle outputs, computed once a module per scene."""
    cache = {}

    def get(name):
        if name not in cache:
            _, _, jcam, arrays, extra = scene(name)
            js = j_screen(jcam, *map(jnp.asarray, arrays))
            bg = jnp.asarray(BG.get(name, (0.0, 0.0, 0.0)), jnp.float32)
            feats = jnp.concatenate([js.rgb, js.depth[:, None]] + ([jnp.asarray(extra)] if extra is not None
                                                                   else []), axis=-1)
            raw = j_reference_render(js, feats, jcam.H, jcam.W)
            ref = j_render_reference(js, jcam.H, jcam.W, bg,
                                         extra_features=None if extra is None else jnp.asarray(extra))
            entry = {"screen": js, "feats": np.asarray(feats), "raw": [np.asarray(v) for v in raw],
                     "ref": {k: np.asarray(v) for k, v in ref.items()}}
            if name == "gradient":
                tgt = jnp.asarray(GRAD_TARGET)

                def f(*leaves):
                    s = j_screen(jcam, *leaves)
                    return gradient_loss(tgt)(j_render_reference(s, jcam.H, jcam.W, bg))

                val, grads = jax.value_and_grad(f, argnums=(0, 1, 2, 3, 4))(*map(jnp.asarray, arrays))
                entry["loss"], entry["grads"] = float(val), [np.asarray(gr) for gr in grads]
            cache[name] = entry
        return cache[name]

    return get


@pytest.mark.parametrize("name", list(SCENES))
def test_oracle_matches_jax(jax_refs, name):
    """The port's oracle on JAX's screen equals JAX's; the port's whole
    oracle path (its preprocess, render_reference) is within PATH_ATOL of
    JAX's, and so are the gradients of the gradient-parity loss."""
    cam, g, _, _, extra = scene(name)
    ref = jax_refs(name)
    raw = t_reference_render(to_torch_screen(ref["screen"]), torch.as_tensor(ref["feats"]), cam.H, cam.W)
    np.testing.assert_allclose(raw.features.numpy(), ref["raw"][0], rtol=0, atol=ORACLE_ATOL)
    np.testing.assert_allclose(raw.transmittance.numpy(), ref["raw"][1], rtol=0, atol=ORACLE_ATOL)

    bg = torch.tensor(BG.get(name, (0.0, 0.0, 0.0)))
    ex = None if extra is None else torch.as_tensor(extra)
    out = trast.render_reference(t_screen(cam, *g), cam.H, cam.W, bg, extra_features=ex)
    assert set(out) == set(ref["ref"])
    for k, v in out.items():
        np.testing.assert_allclose(v.numpy(), ref["ref"][k], rtol=0, atol=PATH_ATOL, err_msg=k)
    if name == "gradient":
        leaves = [x.clone().requires_grad_(True) for x in g]
        loss = gradient_loss(torch.as_tensor(GRAD_TARGET))(trast.render_reference(t_screen(cam, *leaves), cam.H,
                                                                                   cam.W, bg))
        grads = torch.autograd.grad(loss, leaves)
        np.testing.assert_allclose(float(loss.detach()), ref["loss"], rtol=1e-6)
        for nm, got, want in zip(NAMES, grads, ref["grads"]):
            scale = max(float(np.abs(want).max()), 1e-8)
            np.testing.assert_allclose(got.numpy() / scale, want / scale, rtol=0, atol=GRAD_ATOL_SCALED,
                                       err_msg=nm)


@pytest.mark.parametrize("name", [*SCENES, "tile_overflow", "empty"])
def test_rasterize_matches_oracle(name):
    """TestTileVsOracle on the port: rasterize (the instance layout, the
    kernels' plain versions on the CPU) against render_reference."""
    if name == "tile_overflow":
        # a tiny tile capacity: the nearest Gaussians win, most pixels
        # still match (64, not the JAX test's 128: this draw's deepest
        # tile holds fewer than 128, and the case must drop some)
        cam, *g = oracle_case(6, 200, 48, 64, "cpu")
        screen, bg = t_screen(cam, *g), torch.zeros(3)
        small = trast.RasterizeConfig(tile_capacity=64, instance_capacity=2**14)
        out = trast.rasterize(screen, cam.H, cam.W, bg, config=small)
        ref = trast.render_reference(screen, cam.H, cam.W, bg)
        assert int(out["overflow"]) > 0
        assert float(((out["rgb"] - ref["rgb"]).abs() < 1e-3).float().mean()) > 0.8
        return
    if name == "empty":
        cam, *g = oracle_case(7, 16, 48, 64, "cpu")
        screen = t_screen(cam, *g)
        screen = screen._replace(valid=torch.zeros_like(screen.valid),
                                 tiles_touched=torch.zeros_like(screen.tiles_touched))
        bg = torch.tensor([0.3, 0.6, 0.9])
        out = trast.rasterize(screen, cam.H, cam.W, bg, config=T_CFG)
        ref = trast.render_reference(screen, cam.H, cam.W, bg)
        np.testing.assert_allclose(out["rgb"].numpy(), np.broadcast_to(bg.numpy(), (cam.H, cam.W, 3)), atol=1e-6)
        np.testing.assert_allclose(out["acc"].numpy(), 0.0, atol=1e-6)
        np.testing.assert_array_equal(ref["rgb"].numpy(), out["rgb"].numpy())
        return
    cam, g, _, _, extra = scene(name)
    bg = torch.tensor(BG.get(name, (0.0, 0.0, 0.0)))
    ex = None if extra is None else torch.as_tensor(extra)
    if name == "gradient":
        target = torch.as_tensor(GRAD_TARGET)
        res = {}
        for path, render in (("oracle", lambda s: trast.render_reference(s, cam.H, cam.W, bg)),
                             ("tile", lambda s: trast.rasterize(s, cam.H, cam.W, bg, config=T_CFG))):
            leaves = [x.clone().requires_grad_(True) for x in g]
            loss = gradient_loss(target)(render(t_screen(cam, *leaves)))
            res[path] = (float(loss.detach()), torch.autograd.grad(loss, leaves))
        np.testing.assert_allclose(res["tile"][0], res["oracle"][0], rtol=1e-5)
        for nm, got, want in zip(NAMES, res["tile"][1], res["oracle"][1]):
            scale = max(float(want.abs().max()), 1e-8)
            np.testing.assert_allclose((got / scale).numpy(), (want / scale).numpy(), rtol=0,
                                       atol=TILE_GRAD_ATOL_SCALED, err_msg=nm)
        return
    screen = t_screen(cam, *g)
    out = trast.rasterize(screen, cam.H, cam.W, bg, extra_features=ex, config=T_CFG)
    ref = trast.render_reference(screen, cam.H, cam.W, bg, extra_features=ex)
    assert int(out["overflow"]) == 0
    if name == "semantic":
        np.testing.assert_allclose(out["extra"].numpy(), ref["extra"].numpy(), rtol=0, atol=2e-4)
        return
    tol = 5e-5 if name == "opaque" else 2e-5
    np.testing.assert_allclose(out["rgb"].numpy(), ref["rgb"].numpy(), rtol=0, atol=tol)
    np.testing.assert_allclose(out["acc"].numpy(), ref["acc"].numpy(), rtol=0, atol=tol)
    if name != "opaque":
        np.testing.assert_allclose(out["depth"].numpy(), ref["depth"].numpy(), rtol=0, atol=2e-4)


# name: (seed, n, keyword arguments beyond the cloud); the cases of
# tests/test_simple_renderer.py plus the scale modifier, alive rows and
# the table layout
RENDER_CASES = {
    "shs": (3, 300, {"sh_degree": 2, "bg_color": (0.1, 0.2, 0.3)}),
    "colors_precomp": (4, 100, {"colors_precomp": True, "bg_color": (0.0, 1.0, 0.0)}),
    "scaling_modifier": (3, 300, {"sh_degree": 2, "scaling_modifier": 0.6}),
    "alive": (3, 300, {"sh_degree": 3, "alive": True}),
    "table": (3, 300, {"sh_degree": 2, "layout": "table"}),
}


@pytest.mark.parametrize("name", [*RENDER_CASES, "one_color_source"])
def test_render_gaussians_matches_jax(name):
    if name == "one_color_source":
        cam, means, scales, quats, opacity, shs = oracle_case(5, 10, 48, 64, "cpu")
        with pytest.raises(ValueError):
            t_render_gaussians(cam, means, scales, quats, opacity, config=T_CFG)
        with pytest.raises(ValueError):
            t_render_gaussians(cam, means, scales, quats, opacity, shs=shs, colors_precomp=torch.zeros(10, 3),
                               config=T_CFG)
        return
    seed, n, kw = RENDER_CASES[name]
    cam, *g = oracle_case(seed, n, 48, 64, "cpu")
    jcam = j_make_camera(cam.K.numpy(), np.eye(4, dtype=np.float32), 48, 64)
    rng = np.random.default_rng(seed + 7)
    tkw, jkw = {}, {}
    layout = kw.get("layout", "instance")
    tcfg = trast.RasterizeConfig(tile_capacity=256, instance_capacity=2**14, layout=layout)
    jcfg = JConfig(tile_capacity=256, instance_capacity=2**14, interpret=True, layout=layout)
    for k, v in kw.items():
        if k == "layout":
            continue
        if k == "colors_precomp":
            v = rng.uniform(size=(n, 3)).astype(np.float32)
        elif k == "alive":
            v = rng.uniform(size=n) < 0.7
        elif k == "bg_color":
            v = np.asarray(v, np.float32)
        if isinstance(v, np.ndarray):
            tkw[k], jkw[k] = torch.as_tensor(v), jnp.asarray(v)
        else:
            tkw[k] = jkw[k] = v
    shs = {} if "colors_precomp" in kw else {"shs": g[4]}
    out = t_render_gaussians(cam, *g[:4], **shs, **tkw, config=tcfg)
    jshs = {} if "colors_precomp" in kw else {"shs": jnp.asarray(g[4].numpy())}
    ref = j_render_gaussians(jcam, *(jnp.asarray(x.numpy()) for x in g[:4]), **jshs, **jkw, config=jcfg)
    for k in ("rgb", "depth", "acc", "T"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), **RENDER_TOL, err_msg=k)
    for k in ("radii", "visibility", "num_instances", "overflow"):
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(ref[k]), err_msg=k)
    assert out["radii"].shape == (n,) and bool(out["visibility"].any())
    if "alive" in kw:
        assert not bool(out["visibility"][~tkw["alive"]].any())
    if "colors_precomp" in kw:
        # covered pixels lean to the override colours, empty ones are the bg exactly
        empty = out["acc"] == 0.0
        assert bool(empty.any())
        np.testing.assert_array_equal(out["rgb"][empty].numpy(), np.tile([0.0, 1.0, 0.0], (int(empty.sum()), 1)))
