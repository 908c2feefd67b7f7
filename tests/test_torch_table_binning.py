"""Port parity: street_gaussians_torch.ops.binning.bin_gaussians (the
dense [num_tiles, tile_capacity] table) against the JAX package's, fed
the same screen. Every output is an integer (the table, the counts and
the overflow counters), so the two must be equal exactly. Also the
consistency of the port's own two binnings: without the corner cull the
instance layout's runs list the same Gaussians in the same order as the
table's rows.
"""

import numpy as np
import pytest
import torch

from street_gaussians_torch.ops import binning as tbin
from street_gaussians_torch.ops.preprocess import GaussianScreenData as TScreen
from street_gaussians_tpu.ops import binning as jbin
from test_binning import make_screen
from test_torch_binning import projected_screen, wide_screen


def carry(screen):
    return TScreen(*[torch.as_tensor(np.array(x)) for x in screen])


def assert_same_table(screen, gx, gy, ic, tc):
    want = jbin.bin_gaussians(screen, gx, gy, ic, tc)
    got = tbin.bin_gaussians(carry(screen), gx, gy, ic, tc)
    for name in jbin.TileBinning._fields:
        g, w = getattr(got, name), np.asarray(getattr(want, name))
        assert g.dtype == torch.int32 and tuple(g.shape) == w.shape, name
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    return want


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("tile_capacity", [8, 64])
def test_table_binning_matches_jax(seed, tile_capacity):
    want = assert_same_table(make_screen(300, 6, 5, seed=seed), 6, 5, 2**13, tile_capacity)
    assert int(want.num_instances) > 500
    assert (int(want.overflow_tile) > 0) == (tile_capacity == 8)  # the small cap binds


def test_table_binning_projected_and_wide_screens_match_jax():
    """Real conics with tied depths and culled rows, and a grid wider
    than 128 tiles (separate rect channels)."""
    screen, gx, gy = projected_screen(0)
    assert_same_table(screen, gx, gy, 2**13, 128)
    screen, gx, gy = wide_screen(2)
    assert_same_table(screen, gx, gy, 2**12, 32)


def test_table_binning_instance_overflow_matches_jax():
    want = assert_same_table(make_screen(300, 6, 5, seed=3), 6, 5, 384, 16)
    assert int(want.overflow_instance) > 0 and int(want.overflow_tile) > 0


def test_table_binning_empty_scene():
    screen = make_screen(50, 4, 4, frac_valid=0.0)
    want = assert_same_table(screen, 4, 4, 2**10, 16)
    assert int(want.num_instances) == 0 and (np.asarray(want.tile_gauss) == -1).all()


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("tile_capacity", [8, 64])
def test_port_instance_binning_matches_port_table(seed, tile_capacity):
    screen = carry(make_screen(300, 6, 5, seed=seed))
    table = tbin.bin_gaussians(screen, 6, 5, 2**13, tile_capacity)
    inst = tbin.bin_gaussians_instances(screen, 6, 5, 2**13, tile_capacity, corner_cull=False)
    for name in ("tile_count", "num_instances", "overflow", "overflow_instance", "overflow_tile"):
        assert torch.equal(getattr(table, name), getattr(inst, name)), name
    kept = torch.zeros(inst.inst_gauss.shape[0], dtype=torch.bool)
    for t in range(30):
        start, n = int(inst.tile_start[t]), int(inst.tile_count[t])
        assert torch.equal(inst.inst_gauss[start:start + n], table.tile_gauss[t, :n])
        assert (table.tile_gauss[t, n:] == -1).all()
        kept[start:start + n] = True
    assert (inst.inst_gauss[~kept] == -1).all()
