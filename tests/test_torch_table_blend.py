"""Port parity: street_gaussians_torch.ops.tile_raster (the dense-table
tile blend, plain versions on the CPU) against the JAX package's Pallas
kernels in interpret mode: `tile_blend` forward, and `jax.vjp` against
`TileBlend`'s backward on a random cotangent.

Cases: counts of 0, under one chunk, exactly 128, between chunks and the
full K = 256; empty slots with opacity 0 and garbage in every other
row; dense opaque tables whose pixels stop early; F = 4 and F = 6.

Forward tolerance: chip_smoke.compare_blend's rule. Both sides carry the
transmittance as a product; the JAX kernel multiplies the 128 lanes of a
chunk as a tree, the port in lane order, so a value agrees within 1e-5 *
max(1, |ref|), except that a pixel whose product lands within rounding
of 1e-4 may stop one Gaussian earlier or later (at most one pixel here,
within 1e-2 of the largest feature).

Backward tolerance: each gradient row (d mean x/y, d conic a/b/c,
d opacity, d features, AbsGS) divided by its largest |JAX value|, to
atol 1e-5: the two differ in the order of f32 sums (the lane products,
the prefix of u, the sums over a tile's 256 pixels), and the conic rows
carry dx^2 ~ 1e3 factors that cancel across pixels.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import compare_blend, random_table_case
from street_gaussians_torch.ops import tile_raster as ttab
from street_gaussians_tpu.ops.tile_raster import tile_blend as jax_blend

ATOL_SCALED = 1e-5
COUNTS = [0, 57, 128, 200, 256, 130]


def table_case(seed, F=4, opacity_hi=0.99, counts=COUNTS):
    return random_table_case(seed, "cpu", grid_x=3, grid_y=2, F=F, K=256, counts=counts,
                             opacity_hi=opacity_hi)


def jax_fwd_vjp(payload, counts, F, grid_x, gout=None):
    fn = lambda p: jax_blend(p, jnp.asarray(counts.numpy()), F, grid_x, True)  # noqa: E731
    out, vjp = jax.vjp(fn, jnp.asarray(payload.numpy()))
    if gout is None:
        return np.array(out), None
    return np.array(out), np.array(vjp(jnp.asarray(gout.numpy()))[0])


@pytest.mark.parametrize("seed,F,opacity_hi", [(0, 4, 0.99), (1, 4, 0.5), (2, 6, 0.99)])
def test_table_blend_matches_jax(seed, F, opacity_hi):
    payload, counts, F, gx = table_case(seed, F, opacity_hi)
    want, _ = jax_fwd_vjp(payload, counts, F, gx)
    got = ttab.tile_blend(payload, counts, F, gx)
    compare_blend(got, torch.as_tensor(want), F, f"table blend seed {seed}")
    assert (got[0, :, :F] == 0).all() and (got[0, :, F] == 1).all()  # the empty tile
    if opacity_hi > 0.9:  # the dense case must actually stop pixels early
        assert (want[..., -1] < 1e-3).any()


def test_count_only_sets_the_number_of_chunks():
    """No lane is masked by the count: a live Gaussian beyond the count
    but inside the last chunk read still blends, as in the JAX kernel;
    one in a chunk beyond cdiv(count, 128) does not."""
    payload, counts, F, gx = table_case(3, counts=[100] * 6)
    payload[:, 5, 100:] = 0.0
    base = ttab.tile_blend(payload, counts, F, gx)
    near, far = payload.clone(), payload.clone()
    for p, lane in ((near, 110), (far, 140)):
        p[:, :, lane] = payload[:, :, 3]
        p[:, 5, lane] = 0.9
    assert torch.equal(ttab.tile_blend(far, counts, F, gx), base)
    got = ttab.tile_blend(near, counts, F, gx)
    assert not torch.equal(got, base)
    want, _ = jax_fwd_vjp(near, counts, F, gx)
    compare_blend(got, torch.as_tensor(want), F, "live lane beyond the count")


@pytest.mark.parametrize("seed,F,opacity_hi", [(0, 4, 0.99), (1, 4, 0.5), (4, 6, 0.3)])
def test_table_blend_backward_matches_jax_vjp(seed, F, opacity_hi):
    payload, counts, F, gx = table_case(seed, F, opacity_hi)
    T = counts.numel()
    gout = torch.as_tensor(np.random.default_rng(seed + 10).normal(size=(T, 256, F + 1)).astype(np.float32))
    _, want = jax_fwd_vjp(payload, counts, F, gx, gout)
    p = payload.clone().requires_grad_(True)
    out = ttab.TileBlend.apply(p, counts, F, gx)
    out.backward(gout)
    got = p.grad.numpy()
    rows = lambda a: a.transpose(1, 0, 2).reshape(a.shape[1], -1)  # noqa: E731
    g, w = rows(got), rows(want)
    for r in range(6 + F + 2):
        scale = max(np.abs(w[r]).max(), 1e-30)
        np.testing.assert_allclose(g[r] / scale, w[r] / scale, atol=ATOL_SCALED, rtol=0, err_msg=f"row {r}")
    assert (g[6 + F + 2:] == 0).all()
    # empty slots and the chunks never read have gradient 0
    empty = np.arange(256)[None, :] >= counts.numpy()[:, None]
    assert (got.transpose(0, 2, 1)[empty] == 0).all()
    assert torch.equal(p.grad, ttab.tile_blend_bwd(payload, counts, out.detach(), gout, F, gx))


def test_chunks_after_every_pixel_stopped_keep_zero_gradient():
    """An opaque first chunk stops every pixel: the second chunk is
    skipped, and its lanes keep gradient 0 although they are live."""
    payload, counts, F, gx = table_case(5, counts=[256] * 6)
    tile = torch.arange(6)
    payload[:, 0, :128] = ((tile % gx) * 16 + 8.0)[:, None]
    payload[:, 1, :128] = ((tile // gx) * 16 + 8.0)[:, None]
    payload[:, 2, :128] = 1e-4
    payload[:, 3, :128] = 0.0
    payload[:, 4, :128] = 1e-4
    payload[:, 5, :128] = 0.9
    out = ttab.tile_blend(payload, counts, F, gx)
    assert (out[..., F] < 1e-3).all()
    d = ttab.tile_blend_bwd(payload, counts, out, torch.ones_like(out), F, gx)
    assert (d[:, :, 128:] == 0).all() and (d[:, :, :128] != 0).any()
    _, want = jax_fwd_vjp(payload, counts, F, gx, torch.ones_like(out))
    assert (want[:, :, 128:] == 0).all()


def test_work_counts_and_wrapper_checks():
    payload, counts, F, gx = table_case(6)
    _, work = ttab.tile_blend_plain(payload, counts, F, gx, return_work=True)
    pairs = 256 * int(counts.sum())
    assert 0 < int(work["blended"]) <= int(work["evaluated"]) < pairs
    assert int(work["chunks"]) <= int(((counts + 127) // 128).sum())
    with pytest.raises(ValueError, match="multiple of 128"):
        ttab.tile_blend(payload[:, :, :200], counts, F, gx)
    with pytest.raises(ValueError, match="int32"):
        ttab.tile_blend(payload, counts.to(torch.int64), F, gx)
    with pytest.raises(ValueError, match="rows"):
        ttab.tile_blend(payload[:, :8], counts, F, gx)
