"""Port parity: street_gaussians_torch.ops.tile_raster2.tile_blend_instances
(plain version on the CPU) against the JAX package's Pallas kernel in
interpret mode, on a random ragged payload and on the toy scene's own
payload.

Tolerance: rtol = atol = 1e-5. Both carry the transmittance in log space
with the same termination test; they differ only in the order of their
f32 sums (the in-block prefix, the feature dot product), a few ulp of
values up to the depth feature's ~50.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from chip_smoke import random_blend_case
from street_gaussians_torch.ops import rasterize as trast
from street_gaussians_torch.ops import tile_raster2 as tblend
from street_gaussians_torch.ops.preprocess import GaussianScreenData as TScreen
from street_gaussians_torch.ops.tile_raster2 import payload_rows
from street_gaussians_tpu.models.renderer import screen_space
from street_gaussians_tpu.ops import binning as jbin
from street_gaussians_tpu.ops.rasterize import build_payload_blocks
from street_gaussians_tpu.ops.tile_raster2 import tile_blend_instances as jax_blend

TOL = dict(rtol=1e-5, atol=1e-5)


def random_payload(seed, opacity_hi=0.99):
    """Ragged runs over a 3x2 grid, several crossing 128-lane blocks."""
    return random_blend_case(seed, "cpu", grid_x=3, grid_y=2, max_count=300, opacity_hi=opacity_hi)


def _blend_both(payload, starts, counts, F, grid_x, T):
    want = np.asarray(
        jax_blend(
            jnp.asarray(payload.numpy()), jnp.asarray(starts.numpy()), jnp.asarray(counts.numpy()),
            F, grid_x, T, int(counts.max()) + 1, True,
        )
    )
    got = tblend.tile_blend_instances(payload, starts, counts, F, grid_x, T).numpy()
    return got, want


@pytest.mark.parametrize("seed,opacity_hi", [(0, 0.99), (1, 0.6)])
def test_blend_random_ragged_matches_jax(seed, opacity_hi):
    got, want = _blend_both(*random_payload(seed, opacity_hi=opacity_hi))
    np.testing.assert_allclose(got, want, **TOL)
    # the dense case must actually terminate pixels early
    if opacity_hi > 0.9:
        assert (want[..., -1] < 1e-3).any()


def test_blend_empty_tiles_write_empty_state():
    payload, starts, counts, F, gx, T = random_payload(2)
    got = tblend.tile_blend_instances(payload, starts, torch.zeros_like(counts), F, gx, T).numpy()
    assert (got[..., :F] == 0).all() and (got[..., F] == 1).all()


def test_blend_toy_scene_payload_matches_jax():
    """The toy scene's own payload (graft entry point, 32x48): the port's
    binning and payload gather must rebuild the JAX payload exactly, and
    the blend must match within TOL."""
    scene, params, opts = graft._toy_setup()
    frame = scene.frames[2]
    screen, _ = screen_space(
        params, scene.aux, scene.table, scene.pose_data, frame, jnp.asarray(0), opts=opts
    )
    H, W = frame.cam.H, frame.cam.W
    gx, gy = (W + 15) // 16, (H + 15) // 16
    F = 4
    bins = jbin.bin_gaussians_instances(
        screen, gx, gy, opts.instance_capacity, opts.tile_capacity, interpret=True
    )
    feats = jnp.concatenate([screen.rgb, screen.depth[:, None]], axis=-1)
    src = jnp.concatenate([screen.mean2d, screen.conic, screen.opacity[:, None], feats], -1)
    src = jnp.pad(src, ((0, 0), (0, payload_rows(F) - src.shape[1])))
    payload = np.asarray(build_payload_blocks(src, bins.inst_gauss, True))

    tscreen = TScreen(*[torch.as_tensor(np.array(x)) for x in screen])
    cfg = trast.RasterizeConfig(
        tile_capacity=opts.tile_capacity, instance_capacity=opts.instance_capacity
    )
    bi = trast.blend_inputs(tscreen, H, W, config=cfg)
    np.testing.assert_array_equal(bi.payload.numpy(), payload)
    np.testing.assert_array_equal(bi.bins.tile_start.numpy(), np.asarray(bins.tile_start))
    np.testing.assert_array_equal(bi.bins.tile_count.numpy(), np.asarray(bins.tile_count))

    got, want = _blend_both(
        *[torch.as_tensor(np.array(x)) for x in (payload, bins.tile_start, bins.tile_count)],
        F, gx, gx * gy,
    )
    np.testing.assert_allclose(got, want, **TOL)


def test_plain_work_counts_reached_pairs():
    """return_work counts every valid (pixel, instance) pair before the
    stop: with nothing opaque enough to stop, that is 256 x instances;
    with dense opaque runs, pixels stop and evaluate fewer."""
    for opacity_hi, stops in ((0.02, False), (0.99, True)):
        payload, starts, counts, F, gx, T = random_payload(3, opacity_hi=opacity_hi)
        _, work = tblend.tile_blend_plain(payload, starts, counts, F, gx, T, return_work=True)
        pairs = 256 * int(counts.sum())
        assert (int(work["evaluated"]) < pairs) == stops
        assert 0 < int(work["blended"]) <= int(work["evaluated"]) <= pairs
