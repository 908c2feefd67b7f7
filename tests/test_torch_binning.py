"""Port parity: street_gaussians_torch.ops.binning.bin_gaussians_instances
against the JAX package's (run expansion in Pallas interpret mode), fed
the same screen. Every output is an integer (the lists, tile_start,
tile_count and the overflow counters), so the two must be equal exactly.
Both layouts also equal, exactly, the scan formulation that the run
expansion replaced (tests/binning_scan_oracle.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from binning_scan_oracle import scan_bin_gaussians, scan_bin_gaussians_instances, scan_rank
from street_gaussians_torch.ops import binning as tbin
from street_gaussians_torch.ops.preprocess import GaussianScreenData as TScreen
from street_gaussians_tpu.ops import binning as jbin
from street_gaussians_tpu.ops.preprocess import GaussianScreenData, preprocess_gaussians
from street_gaussians_tpu.utils.camera import make_camera


def projected_screen(seed, n=400, H=96, W=160):
    """JAX preprocess of random Gaussians in front of a camera: real
    conics (so the corner cull bites), some tied depths, some culled."""
    rng = np.random.default_rng(seed)
    K = np.array([[100.0, 0, W / 2], [0, 100.0, H / 2], [0, 0, 1]], np.float32)
    cam = make_camera(K, np.eye(4, dtype=np.float32), H, W)
    xyz = np.stack(
        [rng.uniform(-4, 4, n), rng.uniform(-2.5, 2.5, n), rng.uniform(-1, 12, n)], -1
    ).astype(np.float32)
    xyz[1::17, 2] = xyz[0, 2]  # ties: order falls back to the original index
    scales = np.exp(rng.uniform(-3.5, -0.5, (n, 3))).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    op = rng.uniform(0.002, 0.99, n).astype(np.float32)
    return preprocess_gaussians(
        jnp.asarray(xyz), jnp.asarray(scales), jnp.asarray(quats), jnp.asarray(op), None,
        cam.w2c, cam.full_proj, cam.cam_center, H, W, cam.focal_x, cam.focal_y,
        cam.tan_fovx, cam.tan_fovy, colors_precomp=jnp.zeros((n, 3)),
    ), (W + 15) // 16, (H + 15) // 16


def wide_screen(seed, n=300, grid_x=130, grid_y=3):
    """Synthetic rects on a panorama-wide grid (grid_x >= 128 takes the
    separate-rect-channel branch)."""
    rng = np.random.default_rng(seed)
    x0 = rng.integers(0, grid_x, n)
    y0 = rng.integers(0, grid_y, n)
    x1 = np.minimum(x0 + rng.integers(1, 5, n), grid_x)
    y1 = np.minimum(y0 + rng.integers(1, 3, n), grid_y)
    tiles = ((x1 - x0) * (y1 - y0) * (rng.uniform(size=n) < 0.8)).astype(np.int32)
    conic = np.stack([rng.uniform(0.001, 0.05, n), np.zeros(n), rng.uniform(0.001, 0.05, n)], -1)
    return GaussianScreenData(
        mean2d=jnp.asarray(np.stack([x0 * 16 + 20.0, y0 * 16 + 10.0], -1).astype(np.float32)),
        depth=jnp.asarray(rng.uniform(1, 50, n).astype(np.float32)),
        conic=jnp.asarray(conic.astype(np.float32)),
        radius=jnp.asarray((tiles > 0).astype(np.float32)),
        rgb=jnp.zeros((n, 3)),
        opacity=jnp.asarray(rng.uniform(0.002, 0.9, n).astype(np.float32)),
        valid=jnp.asarray(tiles > 0),
        rect_min=jnp.asarray(np.stack([x0, y0], -1).astype(np.int32)),
        rect_max=jnp.asarray(np.stack([x1, y1], -1).astype(np.int32)),
        tiles_touched=jnp.asarray(tiles),
    ), grid_x, grid_y


def _assert_same_binning(screen, gx, gy, ic, tc, corner_cull):
    want = jbin.bin_gaussians_instances(
        screen, gx, gy, ic, tc, interpret=True, corner_cull=corner_cull
    )
    tscreen = TScreen(*[torch.as_tensor(np.array(x)) for x in screen])
    got = tbin.bin_gaussians_instances(tscreen, gx, gy, ic, tc, corner_cull=corner_cull)
    for name in jbin.InstanceBinning._fields:
        np.testing.assert_array_equal(
            np.asarray(getattr(got, name)), np.asarray(getattr(want, name)), err_msg=name
        )
    return want


@pytest.mark.parametrize("corner_cull", [True, False])
@pytest.mark.parametrize("tile_capacity", [2**13, 8])
def test_binning_matches_jax(corner_cull, tile_capacity):
    screen, gx, gy = projected_screen(0)
    want = _assert_same_binning(screen, gx, gy, 2**13, tile_capacity, corner_cull)
    assert int(want.num_instances) > 500
    if tile_capacity == 8:  # the cap binds
        assert int(want.overflow_tile) > 0


def test_binning_instance_overflow_matches_jax():
    screen, gx, gy = projected_screen(1)
    want = _assert_same_binning(screen, gx, gy, 384, 64, corner_cull=True)
    assert int(want.overflow_instance) > 0


@pytest.mark.parametrize("corner_cull", [True, False])
def test_binning_wide_grid_matches_jax(corner_cull):
    screen, gx, gy = wide_screen(2)
    _assert_same_binning(screen, gx, gy, 2**12, 2**12, corner_cull)


# ---- against the scan formulation the run expansion replaced


def _screen(kind):
    screen, gx, gy = projected_screen(0) if kind == "projected" else wide_screen(2)
    return TScreen(*[torch.as_tensor(np.array(x)) for x in screen]), gx, gy


@pytest.mark.parametrize("kind", ["projected", "wide"])
@pytest.mark.parametrize("corner_cull", [True, False])
@pytest.mark.parametrize("S,tile_capacity", [(2**13, 2**13), (2**13, 2), (384, 64)])
def test_binning_matches_scan_oracle(kind, corner_cull, S, tile_capacity):
    """Both layouts equal the scan formulation field for field: the
    tile cap by the tile_start gather, and instance overflow."""
    screen, gx, gy = _screen(kind)
    got = tbin.bin_gaussians_instances(screen, gx, gy, S, tile_capacity, corner_cull=corner_cull)
    want = scan_bin_gaussians_instances(screen, gx, gy, S, tile_capacity, corner_cull=corner_cull)
    for name in tbin.InstanceBinning._fields:
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    if not corner_cull:
        got_t = tbin.bin_gaussians(screen, gx, gy, S, tile_capacity)
        want_t = scan_bin_gaussians(screen, gx, gy, S, tile_capacity)
        for name in tbin.TileBinning._fields:
            assert torch.equal(getattr(got_t, name), getattr(want_t, name)), name
    if tile_capacity < S:
        assert int(got.overflow) > 0


@pytest.mark.parametrize("seed", [0, 1])
def test_tile_start_rank_matches_scan_rank(seed):
    """A live row's rank in its tile, s - tile_start[tile], is the scan's
    rank from the last tile boundary; dead rows (num_tiles) sort last."""
    gen = torch.Generator().manual_seed(seed)
    num_tiles = 50
    st = torch.sort(torch.randint(0, num_tiles + 1, (4000,), generator=gen, dtype=torch.int32)).values
    queries = torch.arange(num_tiles + 1, dtype=torch.int32)
    tile_start = torch.searchsorted(st, queries, side="left").to(torch.int32)
    rank = torch.arange(st.shape[0], dtype=torch.int32) - tile_start[st.long()]
    live = st < num_tiles
    assert torch.equal(rank[live], scan_rank(st, num_tiles)[live])
    assert int(rank[live].max()) > 8
