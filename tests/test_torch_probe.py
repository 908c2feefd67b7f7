"""The blend probe (street_gaussians_torch/script/probe_kernel.py) on the
CPU: the floor's plain version against a closed form in numpy, the
tensor-core variant's CPU path (the blend's plain version: it computes
the same function), the plain repetition of the variant's segment
algebra (`probe_blend_mma_split_plain`), and the probe end to end at a
toy size.

The floor is held here against what its body states: the sums of rows
0..7 of every payload block of a tile's run, added to all [256, F]
outputs, T = 1; tests/test_torch_probe_jax.py holds both variants
against the JAX script's own kernel bodies in interpret mode.
Tolerances: the floor 1e-5 * the sum of |values| (f32 sums in another
order); the blend by chip_smoke.compare_blend (1e-5 relative, a stop
that lands within rounding of 1e-4 may move by one Gaussian in at most
one pixel). The split form's stop decisions are checked exactly.
"""

import functools

import numpy as np
import pytest
import torch

from chip_smoke import compare_blend, random_blend_case
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


# runs of up to 12 payload blocks on a 3x2 grid (one empty), cut by the
# split form into segments of 1 and 2 blocks, and not at all; at low
# opacity every pixel crosses every cut, at high opacity pixels stop in
# the first segment and in later ones
SPLIT_COUNTS = (1500, 0, 300, 700, 1200, 90)
SPLIT_OPACITY = {"crosses": 0.05, "stops": 0.99}
NO_CUT = 1 << 20


@functools.lru_cache(maxsize=None)
def split_case(name):
    return random_blend_case(4, "cpu", grid_x=3, grid_y=2, counts=SPLIT_COUNTS, opacity_hi=SPLIT_OPACITY[name])


@functools.lru_cache(maxsize=None)
def split_run(name, seg_blocks):
    return probe_kernel.probe_blend_mma_split_plain(*split_case(name), seg_blocks, return_state=True)


@pytest.mark.parametrize("seg_blocks", [1, 2])
@pytest.mark.parametrize("name", list(SPLIT_OPACITY))
def test_split_form_stops_every_pixel_where_the_uncut_walk_does(name, seg_blocks):
    """Exact: the lane at which each pixel stops, the number of lanes it
    blends and its final T are those of the walk without cuts, since a
    segment enters with the fold of the earlier blocks' sums that the
    walk carries."""
    got, st = split_run(name, seg_blocks)
    want, ref = split_run(name, NO_CUT)
    assert st["plan"]["n_long"] > 0 and ref["plan"]["n_long"] == 0
    assert torch.equal(st["stop_lane"], ref["stop_lane"])
    assert torch.equal(st["blended"], ref["blended"])
    assert torch.equal(got[..., -1], want[..., -1])
    later = st["item_seg"] > 0
    if name == "crosses":
        assert (ref["stop_lane"] < 0).all() and st["entered"][later].all()
    else:
        lanes = ref["stop_lane"][ref["stop_lane"] >= 0]
        assert (lanes < 128 * seg_blocks).any() and (lanes >= 128 * seg_blocks).any()
        assert not st["entered"][later].all()


@pytest.mark.parametrize("seg_blocks", [1, 2, NO_CUT])
@pytest.mark.parametrize("name", list(SPLIT_OPACITY))
def test_split_form_matches_the_blend_plain_version(name, seg_blocks):
    case = split_case(name)
    got, _ = split_run(name, seg_blocks)
    compare_blend(got, tile_raster2.tile_blend_plain(*case), case[3], f"split form {name}, {seg_blocks} blocks")
