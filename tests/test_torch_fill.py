"""Port parity: street_gaussians_torch.ops.fill.expand_runs against the
JAX package's expand_runs (Pallas, interpret mode) on test_fill.py's
cases. The function copies values and never sums them, so the two must
agree bit for bit (tolerance 0). And fill.expand_instances' plain
version against the scan formulation it replaced
(tests/binning_scan_oracle.py), exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from binning_scan_oracle import scan_instances
from chip_smoke import random_instances_case
from street_gaussians_torch.ops import fill as tfill
from street_gaussians_tpu.ops.fill import expand_runs as jax_expand_runs


def _both(vals, offs, total, S):
    want = np.asarray(
        jax_expand_runs(
            jnp.asarray(vals), jnp.asarray(offs), jnp.asarray(total, jnp.int32), S,
            interpret=True,
        )
    )
    got = tfill.expand_runs(
        torch.as_tensor(vals), torch.as_tensor(offs),
        torch.tensor(total, dtype=torch.int32), S,
    ).numpy()
    return got, want


def _ragged_case(seed, N=700):
    rng = np.random.default_rng(seed)
    cnt = rng.integers(0, 9, N).astype(np.int32)
    cnt[rng.uniform(size=N) < 0.3] = 0  # plenty of empty runs
    offs = (np.cumsum(cnt) - cnt).astype(np.int32)
    total = int(offs[-1] + cnt[-1])
    vals = np.stack(
        [
            rng.integers(0, 1 << 22, N).astype(np.float32),  # int channel
            rng.normal(size=N).astype(np.float32) * 1e3,
            rng.normal(size=N).astype(np.float32) * 1e-4,
            rng.integers(0, 1 << 20, N).astype(np.float32),
        ]
    )
    return vals, offs, total


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("S", [1024, 2048, 4096 + 512])
def test_expand_runs_matches_jax(seed, S):
    got, want = _both(*_ragged_case(seed), S)
    np.testing.assert_array_equal(got, want)


def test_expand_runs_overflow_clamped_matches_jax():
    """Runs crossing or beyond the slot capacity are clamped."""
    got, want = _both(
        np.array([[3.0, 7.0, 11.0]], np.float32), np.array([0, 5, 9], np.int32), 12, 8
    )
    np.testing.assert_array_equal(got, want)


def test_expand_runs_all_empty_matches_jax():
    got, want = _both(np.ones((2, 16), np.float32), np.zeros(16, np.int32), 0, 1024)
    np.testing.assert_array_equal(got, want)
    assert not got.any()


def test_expand_runs_leading_gap_is_zero():
    """Slots before the first run start belong to no run (plain version
    against a loop over the runs)."""
    vals = np.array([[5.0, 6.0]], np.float32)
    offs = np.array([3, 4], np.int32)
    got = tfill.expand_runs(
        torch.as_tensor(vals), torch.as_tensor(offs), torch.tensor(6, dtype=torch.int32), 8
    ).numpy()
    np.testing.assert_array_equal(got, [[0, 0, 0, 5, 6, 6, 0, 0]])


def test_expand_runs_rejects_2pow24_runs():
    N = 2**24
    with pytest.raises(ValueError, match="2\\*\\*24"):
        tfill.expand_runs(
            torch.zeros((1, N)), torch.zeros((N,), dtype=torch.int32),
            torch.tensor(0, dtype=torch.int32), 512,
        )


def test_expand_runs_cpu_does_not_count_launches():
    before = tfill.expand_runs.launches
    tfill.expand_runs(*[torch.as_tensor(x) for x in _ragged_case(0)[:2]],
                      torch.tensor(10, dtype=torch.int32), 64)
    assert tfill.expand_runs.launches == before


# ---- expand_instances: binning's tiles and Gaussians straight from the runs


@pytest.mark.parametrize("grid", [(40, 30), (130, 3)])  # packed rect; three rect rows
@pytest.mark.parametrize("corner_cull", [True, False])
@pytest.mark.parametrize("pad", [-300, 0, 257])  # instance overflow, exact fit, room to spare
def test_expand_instances_plain_matches_scan(grid, corner_cull, pad):
    """The plain expansion (each slot's run by searchsorted, its offset
    from the run's start) equals the scan formulation exactly, leading
    empty runs and instance overflow included."""
    vals, offs, total, num_ids = random_instances_case(3, 700, torch.device("cpu"), *grid, corner_cull,
                                                       leading_empty=5)
    S = int(total) + pad
    got = tfill.expand_instances(vals, offs, total, S, num_ids, *grid)
    want = scan_instances(vals, offs, total, S, num_ids, *grid)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    live = got[1] >= 0
    assert 0 < int(live.sum()) <= min(S, int(total))
    if corner_cull:  # the cull drops some of the runs' tiles
        assert int(live.sum()) < min(S, int(total))


def test_expand_instances_all_empty_and_no_runs():
    vals, offs, total, num_ids = random_instances_case(0, 50, torch.device("cpu"), corner_cull=False,
                                                       leading_empty=50)
    for v, o in ((vals, offs), (vals[:, :0], offs[:0])):
        tile_id, gauss_id = tfill.expand_instances(v, o, total, 64, num_ids, 40, 30)
        assert (tile_id == 40 * 30).all() and (gauss_id == -1).all()


def test_expand_instances_rejects_bad_rows():
    vals, offs, total, _ = random_instances_case(0, 50, torch.device("cpu"))
    with pytest.raises(ValueError, match="rows"):
        tfill.expand_instances(vals[:4], offs, total, 64, 2, 40, 30)
    with pytest.raises(ValueError, match="128"):
        tfill.expand_instances(vals, offs, total, 64, 2, 130, 3)


def test_expand_instances_cpu_does_not_count_launches():
    before = tfill.expand_instances.launches
    vals, offs, total, num_ids = random_instances_case(0, 50, torch.device("cpu"))
    tfill.expand_instances(vals, offs, total, 64, num_ids, 40, 30)
    assert tfill.expand_instances.launches == before
