"""The blend probe (street_gaussians_torch/script/probe_kernel.py) on the
CPU: the floor's plain version against a closed form in numpy, the
tensor-core variant's CPU path (the blend's plain version: it computes
the same function), and the probe end to end at a toy size.

The JAX package's script/probe_kernel.py cannot run any more (it unpacks
five step tables where tile_raster2._flatten_steps returns two), so the
floor is held against what its body states: the sums of rows 0..7 of
every payload block of a tile's run, added to all [256, F] outputs,
T = 1. Tolerance: 1e-5 * the sum of |values| (f32 sums in another
order).
"""

import numpy as np
import pytest
import torch

from chip_smoke import random_blend_case
from street_gaussians_torch.ops import tile_raster2
from street_gaussians_torch.script import probe_kernel


def test_floor_plain_matches_closed_form():
    payload, starts, counts, F, gx, T = random_blend_case(0, "cpu", grid_x=3, grid_y=2, max_count=300)
    counts[2] = 0
    got = probe_kernel.probe_floor(payload, starts, counts, F, gx, T).numpy()
    p = payload.numpy().astype(np.float64)
    assert got.shape == (T, 256, F + 1) and (got[..., F] == 1).all()
    for t in range(T):
        s, c = int(starts[t]), int(counts[t])
        blocks = range(s // 128, (s + c + 127) // 128) if c else ()
        want = sum(p[b, :8].sum() for b in blocks)
        bound = 1e-5 * sum(np.abs(p[b, :8]).sum() for b in blocks)
        assert (got[t, :, :F] == got[t, 0, 0]).all()
        assert abs(got[t, 0, 0] - want) <= bound, t
    assert (got[2, :, :F] == 0).all()  # an empty tile reads nothing
    # whole blocks are read, lanes of neighbouring runs included
    assert len({int(s) // 128 for s in starts}) < T


def test_variant_on_the_cpu_is_the_blend_plain_version():
    case = random_blend_case(1, "cpu", grid_x=3, grid_y=2, max_count=300)
    assert torch.equal(probe_kernel.probe_blend_mma(*case), tile_raster2.tile_blend_plain(*case))
    assert probe_kernel.probe_blend_mma.launches == 0 and probe_kernel.probe_floor.launches == 0


def test_probe_wrappers_reject_bad_inputs():
    payload, starts, counts, F, gx, T = random_blend_case(2, "cpu", grid_x=2, grid_y=1, max_count=50)
    for fn in (probe_kernel.probe_floor, probe_kernel.probe_blend_mma):
        with pytest.raises(ValueError):
            fn(payload, starts.to(torch.int64), counts, F, gx, T)
        with pytest.raises(ValueError):
            fn(payload[:, :, :64], starts, counts, F, gx, T)


def test_probe_runs_on_the_cpu_at_a_toy_size(capsys):
    case = probe_kernel.bench_payload("cpu", num_bkgd=300, num_actors=1, H=32, W=48)
    assert case[0].shape[1:] == (16, 128) and case[5] == 6
    res = probe_kernel.run_probe(*case, iters=1)
    assert set(res) == {"floor_ms", "current_ms", "variant_ms", "max_abs_diff", "fwd_bwd_ms"}
    assert res["max_abs_diff"] == 0.0 and all(v >= 0 for v in res.values())
    out = capsys.readouterr().out
    assert "max |current - variant|" in out and "fwd+bwd current" in out


def test_probe_needs_a_device_when_cuda_is_absent(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        probe_kernel.bench_payload()
