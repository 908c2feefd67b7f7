"""Port parity: street_gaussians_torch.ops.fill.expand_runs against the
JAX package's expand_runs (Pallas, interpret mode) on test_fill.py's
cases. The function copies values and never sums them, so the two must
agree bit for bit (tolerance 0)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

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
