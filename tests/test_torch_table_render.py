"""Port parity for the dense-table rasterizer path as a whole:
`rasterize(..., RasterizeConfig(layout="table"))` on a preprocessed
64x96 scene (2 actors, 300 background points) against the JAX package's
(Pallas in interpret mode), outputs and gradients, and the port's own
table-against-instance parity function on the CPU.

Tolerances. Outputs: rtol = atol = 1e-5 (f32 sums in another order, a
few ulp of values up to the depth's ~10); the integer counters equal.
Gradients with respect to mean2d, conic, opacity, rgb, depth and
absgrad_dummy: each leaf divided by its largest |JAX value|, to atol
1e-5. The JAX side sums a Gaussian's slots by XLA's scatter-add, the
port by a stable sort and a segmented row-sum, and the blends differ as
tests/test_torch_table_blend.py states.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from street_gaussians_torch.ops import rasterize as trast
from street_gaussians_torch.ops import segsum, tile_raster
from street_gaussians_torch.ops.preprocess import GaussianScreenData as TScreen
from street_gaussians_torch.script import parity_check
from street_gaussians_tpu.data.synthetic import make_synthetic_scene
from street_gaussians_tpu.models import renderer as jrend
from street_gaussians_tpu.ops.rasterize import RasterizeConfig as JaxConfig
from street_gaussians_tpu.ops.rasterize import rasterize as jax_rasterize

TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_ATOL_SCALED = 1e-5
H, W = 64, 96
CAPS = dict(tile_capacity=256, instance_capacity=2**14)
LEAVES = ("mean2d", "conic", "opacity", "rgb", "depth")


@pytest.fixture(scope="module")
def screens():
    """The JAX screen of frame 5 of a small scene, and its torch copy."""
    scene = make_synthetic_scene(num_bkgd=300, num_actors=2, H=H, W=W, seed=3, round_to=128)
    params = jrend.SceneParams(scene.params_init, scene.pose_params_init, None, None, None)
    screen, _ = jrend.screen_space(
        params, scene.aux, scene.table, scene.pose_data, scene.frames[5], jnp.asarray(10**9),
        opts=jrend.RenderOptions(mode="eval"),
    )
    return screen, TScreen(*[torch.as_tensor(np.array(x)) for x in screen])


def test_table_rasterize_matches_jax(screens):
    jscreen, tscreen = screens
    bg = np.array([0.2, 0.5, 0.7], np.float32)
    want = jax_rasterize(jscreen, H, W, jnp.asarray(bg),
                           config=JaxConfig(layout="table", interpret=True, **CAPS))
    got = trast.rasterize(tscreen, H, W, torch.as_tensor(bg),
                          config=trast.RasterizeConfig(layout="table", **CAPS))
    for k in ("rgb", "depth", "acc", "T"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), err_msg=k, **TOL)
    for k in ("num_instances", "overflow", "overflow_instance", "overflow_tile"):
        assert int(got[k]) == int(want[k]), k
    assert int(want["num_instances"]) > 1000 and float(np.asarray(want["acc"]).max()) > 0.5


def test_table_rasterize_gradients_match_jax(screens):
    jscreen, tscreen = screens
    rng = np.random.default_rng(6)
    wts = {k: rng.normal(size=s).astype(np.float32)
           for k, s in (("rgb", (H, W, 3)), ("depth", (H, W)), ("acc", (H, W)))}
    n = tscreen.depth.shape[0]

    def jloss(mean2d, conic, opacity, rgb, depth, dummy):
        s = jscreen._replace(mean2d=mean2d, conic=conic, opacity=opacity, rgb=rgb, depth=depth)
        o = jax_rasterize(s, H, W, jnp.zeros(3), absgrad_dummy=dummy,
                            config=JaxConfig(layout="table", interpret=True, **CAPS))
        return sum(jnp.sum(o[k] * wts[k]) for k in wts)

    want = jax.grad(jloss, argnums=tuple(range(6)))(
        *[getattr(jscreen, k) for k in LEAVES], jnp.zeros((n, 2)))

    leaves = [getattr(tscreen, k).clone().requires_grad_(True) for k in LEAVES]
    dummy = torch.zeros((n, 2), requires_grad=True)
    before = segsum.segment_rowsum.launches, tile_raster.tile_blend.launches
    o = trast.rasterize(tscreen._replace(**dict(zip(LEAVES, leaves))), H, W, torch.zeros(3),
                        absgrad_dummy=dummy, config=trast.RasterizeConfig(layout="table", **CAPS))
    loss = sum((o[k] * torch.as_tensor(wts[k])).sum() for k in wts)
    got = torch.autograd.grad(loss, leaves + [dummy])
    # on the CPU every wrapper takes its plain version: no launch is counted
    assert before == (segsum.segment_rowsum.launches, tile_raster.tile_blend.launches)
    for name, g, w in zip(LEAVES + ("absgrad_dummy",), got, want):
        w = np.asarray(w)
        scale = max(np.abs(w).max(), 1e-30)
        np.testing.assert_allclose(g.numpy() / scale, w / scale, atol=GRAD_ATOL_SCALED, rtol=0, err_msg=name)
    assert float(got[-1].min()) >= 0 and float(got[-1].max()) > 0  # AbsGS sums of |.|


def test_table_gather_gradient_is_the_sorted_segment_sum():
    """build_payload_table's gradient against autograd's own indexing
    gradient (a scatter-add), with empty slots and repeated Gaussians."""
    rng = np.random.default_rng(7)
    tile_gauss = torch.as_tensor(rng.integers(-1, 40, (6, 128)).astype(np.int32))
    src = torch.as_tensor(rng.normal(size=(40, 16)).astype(np.float32)).requires_grad_(True)
    d = torch.as_tensor(rng.normal(size=(6, 16, 128)).astype(np.float32))
    table = trast.build_payload_table(src, tile_gauss)
    (got,) = torch.autograd.grad(table, src, d)
    ref = torch.where((tile_gauss >= 0)[:, :, None], src[tile_gauss.clamp(min=0).long()], 0.0).transpose(1, 2)
    assert torch.equal(table, ref)
    (want,) = torch.autograd.grad(ref, src, d)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_unknown_layout_raises(screens):
    with pytest.raises(ValueError, match="layout"):
        trast.rasterize(screens[1], H, W, torch.zeros(3), config=trast.RasterizeConfig(layout="dense"))


def test_parity_function_on_the_cpu():
    """The slice as a whole: both layouts, forward and gradients, within
    the parity check's own limits, at a small size; a capacity below the
    largest tile is raised to a multiple of 128."""
    logs = []
    res = parity_check.parity_check(
        device="cpu", H=H, W=W, num_bkgd=600, num_actors=2, tile_capacity=128,
        instance_capacity=2**14, iters=1, log=logs.append,
    )
    assert res["max_tile_count"] > 128 and res["tile_capacity"] == 256
    assert any("raised to 256" in ln for ln in logs) and logs[-1] == "TABLE/INSTANCE PARITY OK"
    assert all(d < parity_check.FWD_TOL for d in res["max_abs_diff"].values())
    assert set(res["grad"]) == set(parity_check.GRAD_LEAVES)
    assert set(res["fwd_ms"]) == set(res["fwd_bwd_ms"]) == {"table", "instance"}


def test_parity_function_fails_on_overflow():
    with pytest.raises(AssertionError, match="dropped"):
        parity_check.parity_check(device="cpu", H=H, W=W, num_bkgd=600, num_actors=2,
                                  tile_capacity=256, instance_capacity=1024, iters=1, log=lambda s: None)
