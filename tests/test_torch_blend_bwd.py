"""Port parity: the tile blend's backward. `tile_blend_bwd_plain` (what
`tile_blend_bwd` and `TileBlendInstances.backward` run on the CPU)
against `jax.vjp` of the JAX package's tile_blend_instances (Pallas in
interpret mode), on random ragged runs: boundary blocks shared by two
tiles, empty tiles, a first run that starts mid-block, and dense opaque
runs whose pixels stop early.

Tolerance: each gradient row (d mean x/y, d conic a/b/c, d opacity,
d features, AbsGS) is compared after dividing by its largest |JAX
value|, to atol 1e-5. Both re-walk the runs in the same log-space form
and differ only in the order of f32 sums (the in-block prefixes, the
sums over a tile's 256 pixels); the conic rows carry dx^2 ~ 1e3 factors
that cancel across pixels, hence a scaled and not a relative bound.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import random_blend_case
from street_gaussians_torch.ops import tile_raster2 as tblend
from street_gaussians_tpu.ops.tile_raster2 import tile_blend_instances as jax_blend

ATOL_SCALED = 1e-5


def random_case(seed, opacity_hi):
    return random_blend_case(seed, "cpu", grid_x=3, grid_y=2, max_count=300, opacity_hi=opacity_hi)


def jax_vjp(payload, starts, counts, F, grid_x, T, gout):
    fn = lambda p: jax_blend(  # noqa: E731
        p, jnp.asarray(starts.numpy()), jnp.asarray(counts.numpy()), F, grid_x, T,
        int(counts.max()) + 1, True,
    )
    out, vjp = jax.vjp(fn, jnp.asarray(payload.numpy()))
    (d_payload,) = vjp(jnp.asarray(gout.numpy()))
    return np.asarray(out), np.asarray(d_payload)


def assert_rows_close(got, want, F, live):
    """Per gradient row over the live lanes, scaled by its largest
    |want|. Outside the runs the port writes zeros; the JAX kernel
    leaves those lanes unwritten (NaN in interpret mode), and its
    callers mask them."""
    lanes = lambda a: a.transpose(1, 0, 2).reshape(a.shape[1], -1)  # noqa: E731
    g, w = lanes(got), lanes(want)
    for r in range(6 + F + 2):
        scale = max(np.abs(w[r, live]).max(), 1e-30)
        np.testing.assert_allclose(
            g[r, live] / scale, w[r, live] / scale, atol=ATOL_SCALED, rtol=0, err_msg=f"row {r}"
        )
    assert (g[:, ~live] == 0).all() and (g[6 + F + 2:] == 0).all()


@pytest.mark.parametrize("seed,opacity_hi", [(0, 0.99), (1, 0.6), (4, 0.3)])
def test_blend_backward_matches_jax_vjp(seed, opacity_hi):
    payload, starts, counts, F, gx, T = random_case(seed, opacity_hi)
    gout = torch.as_tensor(np.random.default_rng(seed + 10).normal(size=(T, 256, F + 1)).astype(np.float32))
    out_j, want = jax_vjp(payload, starts, counts, F, gx, T, gout)
    out = tblend.tile_blend_instances(payload, starts, counts, F, gx, T)
    got = tblend.tile_blend_bwd(payload, starts, counts, out, gout, F, gx, T).numpy()
    slot = np.arange(payload.shape[0] * 128)
    s, c = starts.numpy()[:, None], counts.numpy()[:, None]
    live = ((slot[None, :] >= s) & (slot[None, :] < s + c)).any(axis=0)
    assert_rows_close(got, want, F, live)
    if opacity_hi > 0.9:
        assert (out_j[..., -1] < 1e-3).any()  # pixels stop early
    # some boundary block is shared by two tiles
    ends = (s + c)[:, 0]
    assert any(((e - 1) // 128 == st // 128) and cc > 0 and e % 128
               for e, st, cc in zip(ends[:-1], s[1:, 0], c[1:, 0]))


def test_autograd_function_routes_to_the_backward():
    """TileBlendInstances.apply: forward = tile_blend_instances, payload
    gradient = tile_blend_bwd (the plain version, on the CPU)."""
    payload, starts, counts, F, gx, T = random_case(2, 0.9)
    gout = torch.as_tensor(np.random.default_rng(3).normal(size=(T, 256, F + 1)).astype(np.float32))
    p = payload.clone().requires_grad_(True)
    out = tblend.TileBlendInstances.apply(p, starts, counts, F, gx, T)
    out.backward(gout)
    ref_out = tblend.tile_blend_instances(payload, starts, counts, F, gx, T)
    assert torch.equal(out.detach(), ref_out)
    assert torch.equal(p.grad, tblend.tile_blend_bwd(payload, starts, counts, ref_out, gout, F, gx, T))


def test_zero_cotangent_gives_zero_gradient():
    payload, starts, counts, F, gx, T = random_case(5, 0.9)
    out = tblend.tile_blend_instances(payload, starts, counts, F, gx, T)
    d = tblend.tile_blend_bwd(payload, starts, counts, out, torch.zeros_like(out), F, gx, T)
    assert (d == 0).all()
