"""The port's CUDA kernels against their plain PyTorch versions, on the
card, and the kernel build's cache key. Without a CUDA card every test
marked `cuda` skips. This file imports no JAX, so it also runs where JAX
is absent:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import math
import os

import numpy as np
import pytest
import torch

from binning_scan_oracle import scan_bin_gaussians, scan_bin_gaussians_instances
from chip_smoke import (
    LONG_OPACITIES,
    LONG_TABLE_OPACITIES,
    SEG_RTOL,
    compare_blend,
    compare_blend_bwd,
    check_probe_case,
    check_table_repeat_and_zeros,
    live_lanes,
    long_blend_case,
    long_table_case,
    oracle_phase,
    random_blend_case,
    random_expand_case,
    random_instances_case,
    random_table_case,
    small_runner_check,
    small_step_check,
    wide_blend_checks,
)
from street_gaussians_torch.kernels import _build
from street_gaussians_torch.ops import binning, fill, rasterize, segsum, tile_raster, tile_raster2
from street_gaussians_torch.script import probe_kernel

# kernel B: the two differ only in the order of f32 sums (see
# tests/test_torch_blend.py)
BLEND_TOL = dict(rtol=1e-5, atol=1e-5)
# blend backward: each gradient row scaled by its largest |plain value|
# (see tests/test_torch_blend_bwd.py); the plain version's prefix sums
# are parallel scans on the card, so their rounding differs more
BWD_ATOL_SCALED = 1e-4
# segment sums: f32 sums of a few normal rows, in the kernel's fixed
# order and in atomic order in the plain version's index_add_
SEG_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("pad", [-4104, 0, 333])
def test_expand_runs_kernel_matches_plain(cuda_device, pad):
    """Exact: the kernel copies values. S below, at and above total."""
    v, o, t, S = random_expand_case(2, 5000, cuda_device)
    before = fill.expand_runs.launches
    got = fill.expand_runs(v, o, t, S + pad)
    torch.cuda.synchronize()
    assert fill.expand_runs.launches == before + 1
    assert torch.equal(got, fill.expand_runs_plain(v, o, t, S + pad))


@pytest.mark.cuda
@pytest.mark.parametrize("grid", [(40, 30), (130, 3)])  # the rect packed in one row; in three (>= 128 tiles)
@pytest.mark.parametrize("corner_cull", [True, False])
@pytest.mark.parametrize("pad", [-4104, 0, 333])  # instance overflow, exact fit, room to spare
def test_expand_instances_kernel_matches_plain(cuda_device, grid, corner_cull, pad):
    """Exact: ragged runs with empty ones (leading ones too), and the
    cull's ties in float32 rounded as PyTorch's separate ops round."""
    vals, offs, total, num_ids = random_instances_case(2, 50_000, cuda_device, *grid, corner_cull,
                                                       leading_empty=7)
    S = int(total) + pad
    before = fill.expand_instances.launches
    got = fill.expand_instances(vals, offs, total, S, num_ids, *grid)
    torch.cuda.synchronize()
    assert fill.expand_instances.launches == before + 1
    want = fill.expand_instances_plain(vals, offs, total, S, num_ids, *grid)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("tile_capacity", [None, 256])  # the serve options' (no cap); one that binds
def test_binning_matches_the_scan_on_the_bench_frame(cuda_device, tile_capacity):
    """Both layouts on the bench frame (1600x1064, 661,248 rows) equal,
    field for field, the scan formulation the run expansion replaced;
    one expand_instances launch a binning."""
    from street_gaussians_torch import serve
    from street_gaussians_torch.models.renderer import screen_space

    scene, params = serve.bench_scene(seed=0, device=cuda_device)
    opts, frame = serve.SERVE_OPTS, scene.frames[0]
    with torch.no_grad():
        screen, _ = screen_space(params, scene.aux, scene.table, scene.pose_data, frame, serve.SERVE_STEP,
                                 opts=opts)
    gx, gy = (frame.cam.W + 15) // 16, (frame.cam.H + 15) // 16
    S, tc = opts.instance_capacity, tile_capacity or opts.tile_capacity
    before = fill.expand_instances.launches
    got = binning.bin_gaussians_instances(screen, gx, gy, S, tc, corner_cull=opts.corner_cull)
    assert fill.expand_instances.launches == before + 1
    want = scan_bin_gaussians_instances(screen, gx, gy, S, tc, corner_cull=opts.corner_cull)
    for name in binning.InstanceBinning._fields:
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    assert int(got.num_instances) > 1_000_000 and (int(got.overflow_tile) > 0) == (tile_capacity is not None)
    tc = tile_capacity or 2048
    got = binning.bin_gaussians(screen, gx, gy, S, tc)
    assert fill.expand_instances.launches == before + 2
    want = scan_bin_gaussians(screen, gx, gy, S, tc)
    for name in binning.TileBinning._fields:
        assert torch.equal(getattr(got, name), getattr(want, name)), name


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 1])
def test_blend_kernel_matches_plain(cuda_device, seed):
    case = random_blend_case(seed, cuda_device, grid_x=5, grid_y=4, max_count=400)
    got = tile_raster2.tile_blend_instances(*case)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, tile_raster2.tile_blend_plain(*case), **BLEND_TOL)


@pytest.mark.cuda
def test_wrappers_reject_bad_inputs(cuda_device):
    with pytest.raises(ValueError):
        fill.expand_runs(
            torch.zeros((2, 4), device=cuda_device), torch.zeros(4, dtype=torch.int32),
            torch.tensor(0, dtype=torch.int32, device=cuda_device), 8,
        )
    p = torch.zeros((2, 80, 128), device=cuda_device)
    z = torch.zeros(1, dtype=torch.int32, device=cuda_device)
    for F in (0, tile_raster2.MAX_FEATURES + 1):  # past the kernels' cap
        with pytest.raises(ValueError, match="MAX_FEATURES"):
            tile_raster2.tile_blend_instances(p, z, z, F, 1, 1)


def _bwd_case(seed, dev):
    case = random_blend_case(seed, dev, grid_x=5, grid_y=4, max_count=400)
    T, F = case[5], case[3]
    gen = torch.Generator().manual_seed(seed)
    gout = torch.randn((T, 256, F + 1), generator=gen).to(dev)
    out = tile_raster2.tile_blend_instances(*case)
    return case, out, gout


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 1])
def test_blend_backward_kernel_matches_plain(cuda_device, seed):
    case, out, gout = _bwd_case(seed, cuda_device)
    payload, starts, counts, F, gx, T = case
    before = tile_raster2.tile_blend_bwd.launches
    got = tile_raster2.tile_blend_bwd(payload, starts, counts, out, gout, F, gx, T)
    torch.cuda.synchronize()
    assert tile_raster2.tile_blend_bwd.launches == before + 1
    want = tile_raster2.tile_blend_bwd_plain(payload, starts, counts, out, gout, F, gx, T)
    for r in range(6 + F + 2):
        scale = want[:, r].abs().max().clamp(min=1e-30)
        torch.testing.assert_close(got[:, r] / scale, want[:, r] / scale, rtol=0, atol=BWD_ATOL_SCALED)
    assert (got[:, 6 + F + 2:] == 0).all()


def _seg_case(seed, dev, explicit):
    rng = np.random.default_rng(seed)
    N = 5000
    keys = np.sort(rng.integers(0, N, size=20000)).astype(np.int32)
    keys[-777:] = segsum.BIG  # padding rows
    d = torch.as_tensor(rng.normal(size=(12, keys.size)).astype(np.float32), device=dev)
    k = torch.as_tensor(keys, device=dev)
    if not explicit:
        return (d, k), dict(num_segments=N)
    offs = np.sort(rng.integers(0, N, size=700)).astype(np.int32)
    ends = np.minimum(np.append(offs[1:], N), offs + rng.integers(0, 30, size=700)).astype(np.int32)
    t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    return (d, k, t(offs), t(ends)), {}


@pytest.mark.cuda
@pytest.mark.parametrize("explicit", [False, True])
def test_segment_rowsum_kernel_matches_plain(cuda_device, explicit):
    args, kw = _seg_case(3, cuda_device, explicit)
    before = segsum.segment_rowsum.launches
    got = segsum.segment_rowsum(*args, **kw)
    torch.cuda.synchronize()
    assert segsum.segment_rowsum.launches == before + 1
    torch.testing.assert_close(got, segsum.segment_rowsum_plain(*args, **kw), **SEG_TOL)
    cpu = [a.cpu() for a in args]
    if explicit:
        # explicit segments: one thread sums a segment's rows in key
        # order, as the plain version does on the CPU
        want = segsum.segment_rowsum_plain(*cpu, **kw)
    else:
        # identity segments: a segment cut by a thread or tile boundary
        # of the merge-path partition is summed in parts, combined in a
        # fixed order that the emulation repeats on the CPU
        want = segsum.segment_rowsum_emulated(*cpu, **kw)
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["long_segment", "mostly_empty", "all_padding"])
def test_segment_rowsum_kernel_on_ragged_segments(cuda_device, case):
    """Bench-like raggedness: one segment of 20,000 rows (ten tiles of
    the partition) among short ones; an identity space 90% empty, as
    the sky's texels; only padding rows. Bit-equal to the emulation, and
    within SEG_RTOL x sum|rows| of the plain version."""
    rng = np.random.default_rng(7)
    if case == "long_segment":
        N = 3000
        keys = np.sort(np.concatenate([np.full(20_000, 1234), rng.integers(0, N, 9000)]))
    elif case == "mostly_empty":
        N = 200_000
        keys = np.sort(rng.choice(N // 10, 60_000) * 10 + rng.integers(0, 2, 60_000))
    else:
        N = 5000
        keys = np.full(4000, segsum.BIG)
    keys = torch.as_tensor(keys.astype(np.int32), device=cuda_device)
    d = torch.as_tensor(rng.normal(size=(12, keys.numel())).astype(np.float32), device=cuda_device)
    before = segsum.segment_rowsum.launches
    got = segsum.segment_rowsum(d, keys, num_segments=N)
    torch.cuda.synchronize()
    assert segsum.segment_rowsum.launches == before + 1
    assert torch.equal(got.cpu(), segsum.segment_rowsum_emulated(d.cpu(), keys.cpu(), num_segments=N))
    ref = segsum.segment_rowsum_plain(d, keys, num_segments=N)
    abs_sum = segsum.segment_rowsum_plain(d.abs(), keys, num_segments=N)
    assert ((got - ref).abs() <= SEG_RTOL * abs_sum + 1e-30).all()
    assert torch.equal(got, segsum.segment_rowsum(d, keys, num_segments=N))


@pytest.mark.cuda
def test_expand_runs_kernel_on_long_runs(cuda_device):
    """Runs far longer than a tile of the partition (one of 20,000
    slots), a leading gap and empty runs: exact, and equal to the
    expansion walked through the partition in plain PyTorch."""
    cnt = np.array([0, 20_000, 3, 0, 0, 4097, 1, 0, 2048], np.int32)
    offs = (np.cumsum(cnt) - cnt + 5).astype(np.int32)
    total = int(offs[-1] + cnt[-1])
    vals = np.arange(3 * cnt.size, dtype=np.float32).reshape(3, -1) - 7.5
    args = [torch.as_tensor(a, device=cuda_device) for a in (vals, offs)]
    args.append(torch.tensor(total, dtype=torch.int32, device=cuda_device))
    for S in (total - 3000, total + 5000):
        got = fill.expand_runs(*args, S)
        torch.cuda.synchronize()
        assert torch.equal(got, fill.expand_runs_plain(*args, S))
        assert torch.equal(got.cpu(), fill.expand_runs_partitioned(*[a.cpu() for a in args], S))


@pytest.mark.cuda
def test_backward_kernels_repeat_bit_for_bit(cuda_device):
    case, out, gout = _bwd_case(4, cuda_device)
    a = tile_raster2.tile_blend_bwd(*case[:3], out, gout, *case[3:])
    b = tile_raster2.tile_blend_bwd(*case[:3], out, gout, *case[3:])
    args, kw = _seg_case(5, cuda_device, False)
    s1 = segsum.segment_rowsum(*args, **kw)
    s2 = segsum.segment_rowsum(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(a, b) and torch.equal(s1, s2)


@pytest.mark.cuda
def test_blend_autograd_function_takes_the_kernels(cuda_device):
    case, out, gout = _bwd_case(6, cuda_device)
    payload, starts, counts, F, gx, T = case
    p = payload.clone().requires_grad_(True)
    fwd, bwd = tile_raster2.tile_blend_instances.launches, tile_raster2.tile_blend_bwd.launches
    y = tile_raster2.TileBlendInstances.apply(p, starts, counts, F, gx, T)
    y.backward(gout)
    torch.cuda.synchronize()
    assert tile_raster2.tile_blend_instances.launches == fwd + 1
    assert tile_raster2.tile_blend_bwd.launches == bwd + 1
    assert torch.equal(y.detach(), out)
    assert torch.equal(p.grad, tile_raster2.tile_blend_bwd(payload, starts, counts, out, gout, F, gx, T))


@pytest.mark.cuda
@pytest.mark.parametrize("seg_blocks", [1, 4, 1 << 20])
def test_blend_plan_kernel_matches_plain(cuda_device, seg_blocks):
    """The work list is integers: exact. Every run is cut at each
    seg_blocks-th payload block it touches."""
    payload, starts, counts = long_blend_case(0, cuda_device, LONG_OPACITIES[0])[:3]
    got = tile_raster2.blend_plan(starts, counts, payload.shape[0], seg_blocks)
    want = tile_raster2.blend_plan_plain(starts, counts, seg_blocks)
    max_long, max_items = tile_raster2.plan_bounds(payload.shape[0], counts.numel(), seg_blocks)
    assert (got["n_long"], got["n_items"]) == (want["n_long"], want["n_items"])
    assert got["n_long"] <= max_long and got["n_items"] <= max_items
    for k in ("tile_slot", "item_tile", "item_seg"):
        assert torch.equal(got[k], want[k]), k


@pytest.mark.cuda
@pytest.mark.parametrize("opacity", LONG_OPACITIES)
def test_blend_kernels_match_plain_on_long_runs(cuda_device, opacity):
    """Runs of 10,000 lanes and more, split into segments: forward and
    backward by chip_smoke's rules; the backward with the forward's saved
    boundary state and without it, and a repeat, bit for bit."""
    case = long_blend_case(1, cuda_device, opacity)
    payload, starts, counts, F, gx, T = case
    assert int(counts.max()) >= 10_000
    ref = tile_raster2.tile_blend_plain(*case)
    out, state = tile_raster2._forward(*case)
    compare_blend(out, ref, F, f"long runs, opacity {opacity}")
    assert torch.equal(out, tile_raster2.tile_blend_instances(*case))
    stops = ref[..., F] < 2e-4
    assert bool(stops.any()) == (opacity[1] > 0.01)
    gout = torch.randn((T, 256, F + 1), generator=torch.Generator().manual_seed(3)).to(cuda_device)
    got = tile_raster2.tile_blend_bwd(payload, starts, counts, out, gout, F, gx, T)
    want = tile_raster2.tile_blend_bwd_plain(payload, starts, counts, out, gout, F, gx, T)
    compare_blend_bwd(got, want, live_lanes(payload, starts, counts), F, f"long runs backward, opacity {opacity}")
    with_state = tile_raster2.tile_blend_bwd(payload, starts, counts, out, gout, F, gx, T, state=state)
    assert torch.equal(got, with_state)
    p = payload.clone().requires_grad_(True)
    tile_raster2.TileBlendInstances.apply(p, starts, counts, F, gx, T).backward(gout)
    assert torch.equal(p.grad, got)
    assert torch.equal(got, tile_raster2.tile_blend_bwd(payload, starts, counts, out, gout, F, gx, T))


@pytest.mark.cuda
@pytest.mark.parametrize("F", [4, 7, 24, 27, 64])
def test_wide_blend_kernels_match_plain(cuda_device, F):
    """Kernels 2.1, 2.2, 2.5 and 2.6 at F = 4 and 7 (instantiated) and
    past the 8 instantiated counts (24, 27 and 64, the cap: the
    runtime-count kernels), against their plain versions by chip_smoke's
    rules (chip_smoke.wide_blend_checks: random and long-run cases,
    random cotangents on every channel, the instance backward with and
    without the forward's state bit-equal), each launched."""
    err = dict.fromkeys(("tile_blend_instances", "tile_blend_bwd", "tile_blend_table", "tile_blend_table_bwd"), 0.0)
    kernels = (tile_raster2.tile_blend_instances, tile_raster2.tile_blend_bwd, tile_raster.tile_blend,
               tile_raster.tile_blend_bwd)
    before = [k.launches for k in kernels]
    wide_blend_checks(cuda_device, F, err)
    torch.cuda.synchronize()
    assert all(k.launches > b for k, b in zip(kernels, before))
    assert all(np.isfinite(v) for v in err.values())


@pytest.mark.cuda
def test_wide_blend_kernels_repeat_bit_for_bit(cuda_device):
    """At F = 27 the runtime-count kernels repeat bit for bit."""
    case = random_blend_case(3, cuda_device, grid_x=6, grid_y=5, F=27)
    payload, starts, counts, F, gx, T = case
    out = tile_raster2.tile_blend_instances(*case)
    assert torch.equal(out, tile_raster2.tile_blend_instances(*case))
    gout = torch.randn((T, 256, F + 1), generator=torch.Generator().manual_seed(0)).to(cuda_device)
    args = (payload, starts, counts, out, gout, F, gx, T)
    assert torch.equal(tile_raster2.tile_blend_bwd(*args), tile_raster2.tile_blend_bwd(*args))


def _table_bwd_case(seed, dev):
    case = random_table_case(seed, dev, grid_x=5, grid_y=4, K=384)
    payload, counts, F, gx = case
    gen = torch.Generator().manual_seed(seed)
    gout = torch.randn((counts.numel(), 256, F + 1), generator=gen).to(dev)
    return case, tile_raster.tile_blend(*case), gout


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 1])
def test_table_blend_kernel_matches_plain(cuda_device, seed):
    """chip_smoke.compare_blend's rule: the kernel multiplies a chunk's
    lanes in order, the plain version's cumprod is a parallel scan."""
    case = random_table_case(seed, cuda_device, grid_x=5, grid_y=4, K=384)
    before = tile_raster.tile_blend.launches
    got = tile_raster.tile_blend(*case)
    torch.cuda.synchronize()
    assert tile_raster.tile_blend.launches == before + 1
    compare_blend(got, tile_raster.tile_blend_plain(*case), case[2], "table blend kernel")


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 1])
def test_table_blend_backward_kernel_matches_plain(cuda_device, seed):
    (payload, counts, F, gx), out, gout = _table_bwd_case(seed, cuda_device)
    before = tile_raster.tile_blend_bwd.launches
    got = tile_raster.tile_blend_bwd(payload, counts, out, gout, F, gx)
    torch.cuda.synchronize()
    assert tile_raster.tile_blend_bwd.launches == before + 1
    want = tile_raster.tile_blend_bwd_plain(payload, counts, out, gout, F, gx)
    for r in range(6 + F + 2):
        scale = want[:, r].abs().max().clamp(min=1e-30)
        torch.testing.assert_close(got[:, r] / scale, want[:, r] / scale, rtol=0, atol=BWD_ATOL_SCALED)
    assert (got[:, 6 + F + 2:] == 0).all()
    assert torch.equal(got, tile_raster.tile_blend_bwd(payload, counts, out, gout, F, gx))


@pytest.mark.cuda
def test_table_autograd_function_takes_the_kernels(cuda_device):
    (payload, counts, F, gx), out, gout = _table_bwd_case(2, cuda_device)
    p = payload.clone().requires_grad_(True)
    fwd, bwd = tile_raster.tile_blend.launches, tile_raster.tile_blend_bwd.launches
    y = tile_raster.TileBlend.apply(p, counts, F, gx)
    y.backward(gout)
    torch.cuda.synchronize()
    assert (tile_raster.tile_blend.launches, tile_raster.tile_blend_bwd.launches) == (fwd + 1, bwd + 1)
    assert torch.equal(y.detach(), out)
    assert torch.equal(p.grad, tile_raster.tile_blend_bwd(payload, counts, out, gout, F, gx))
    with pytest.raises(ValueError, match="MAX_FEATURES"):  # past the kernels' cap
        tile_raster.tile_blend(payload, counts, tile_raster2.MAX_FEATURES + 1, gx)


@pytest.mark.cuda
@pytest.mark.parametrize("seg_chunks", [1, 2, 8, 16, 1 << 20])
def test_table_plan_kernel_matches_plain(cuda_device, seg_chunks):
    """The table kernels' work list is integers: exact. A tile of more
    than seg_chunks chunks is cut into segments of seg_chunks."""
    payload, counts = long_table_case(0, cuda_device, LONG_TABLE_OPACITIES[0], grid_x=8, grid_y=6)[:2]
    K = payload.shape[2]
    got = tile_raster.table_plan(counts, K, seg_chunks)
    want = tile_raster.table_plan_plain(counts.cpu(), K, seg_chunks)
    assert (got["n_long"], got["n_items"]) == (want["n_long"], want["n_items"])
    assert got["n_items"] <= tile_raster.max_items_bound(counts.numel(), K, seg_chunks)
    assert (want["n_long"] > 0) == (seg_chunks < K // 128)
    for k in ("tile_slot", "item_tile", "item_seg"):
        assert torch.equal(got[k].cpu(), want[k]), k


@pytest.mark.cuda
@pytest.mark.parametrize("opacity_hi", LONG_TABLE_OPACITIES)
def test_table_kernels_on_long_tiles(cuda_device, opacity_hi):
    """Tiles cut into segments: both kernels within chip_smoke's
    tolerances of their plain versions, bit-equal on a repeat, the
    backward with the forward's state bit-equal to the backward without
    it, and exact zeros wherever no walk reaches (check_table_repeat_and_zeros)."""
    payload, counts, F, gx = long_table_case(1, cuda_device, opacity_hi, grid_x=10, grid_y=8)
    out = tile_raster.tile_blend(payload, counts, F, gx)
    compare_blend(out, tile_raster.tile_blend_plain(payload, counts, F, gx), F, "table blend long tiles")
    gen = torch.Generator().manual_seed(3)
    gout = torch.randn(out.shape, generator=gen).to(cuda_device)
    got = check_table_repeat_and_zeros(payload, counts, out, gout, F, gx, "table blend long tiles")
    K = payload.shape[2]
    live = (torch.arange(K, device=cuda_device)[None, :] < counts[:, None]).reshape(-1)
    compare_blend_bwd(got, tile_raster.tile_blend_bwd_plain(payload, counts, out, gout, F, gx), live, F,
                      "table blend backward long tiles")


@pytest.mark.cuda
def test_table_backward_writes_zeros_past_the_walk(cuda_device):
    """An opaque first chunk stops every pixel of every tile: the walk
    reads chunk 0 alone, so every later chunk of the gradient table
    (later slots of the first segment, later segments never entered, the
    slots past a short tile's count) and every row past 8 + F hold
    exactly 0, over memory filled with NaN first; chunk 0 holds the
    gradients."""
    counts = [4096] * 5 + [100]
    payload, counts, F, gx = random_table_case(5, cuda_device, grid_x=3, grid_y=2, K=4096, counts=counts)
    tile = torch.arange(6, device=cuda_device)
    payload[:, 0, :128] = ((tile % gx) * 16 + 8.0)[:, None]
    payload[:, 1, :128] = ((tile // gx) * 16 + 8.0)[:, None]
    payload[:, 2, :128] = 1e-4
    payload[:, 3, :128] = 0.0
    payload[:, 4, :128] = 1e-4
    payload[:, 5, :128] = 0.9
    out, state = tile_raster._forward(payload, counts, F, gx)
    assert state.n_long == 5 * (4096 // 128 // tile_raster.SEG_CHUNKS) and (out[..., F] < 1e-3).all()
    gout = torch.ones_like(out)
    junk = torch.full_like(payload, float("nan"))
    del junk
    d = tile_raster.tile_blend_bwd(payload, counts, out, gout, F, gx, state=state)
    torch.cuda.synchronize()
    assert torch.isfinite(d).all()
    assert (d[:, :, 128:] == 0).all() and (d[:, 6 + F + 2:] == 0).all() and (d[:, :6 + F + 2, :128] != 0).any()
    want = tile_raster.tile_blend_bwd_plain(payload, counts, out, gout, F, gx)
    assert (want[:, :, 128:] == 0).all()
    live = (torch.arange(4096, device=cuda_device)[None, :] < counts[:, None]).reshape(-1)
    compare_blend_bwd(d, want, live, F, "table blend backward, opaque first chunk")


@pytest.mark.cuda
def test_table_gather_gradient_repeats_bit_for_bit(cuda_device):
    rng = np.random.default_rng(8)
    tile_gauss = torch.as_tensor(rng.integers(-1, 500, (64, 256)).astype(np.int32), device=cuda_device)
    src = torch.as_tensor(rng.normal(size=(500, 16)).astype(np.float32), device=cuda_device).requires_grad_(True)
    d = torch.as_tensor(rng.normal(size=(64, 16, 256)).astype(np.float32), device=cuda_device)
    before = segsum.segment_rowsum.launches
    grads = [torch.autograd.grad(rasterize.build_payload_table(src, tile_gauss), src, d)[0] for _ in range(2)]
    torch.cuda.synchronize()
    assert segsum.segment_rowsum.launches == before + 2
    assert torch.equal(*grads)
    ref = torch.where((tile_gauss >= 0)[:, :, None], src[tile_gauss.clamp(min=0).long()], 0.0).transpose(1, 2)
    torch.testing.assert_close(grads[0], torch.autograd.grad(ref, src, d)[0], rtol=1e-5, atol=1e-4)


@pytest.mark.cuda
def test_probe_kernels_match_plain(cuda_device):
    """The floor within 1e-5 of the sum of |values| (f32 sums in another
    order); the tensor-core variant by chip_smoke.compare_blend's rule."""
    case = random_blend_case(3, cuda_device, grid_x=5, grid_y=4, max_count=400)
    before = probe_kernel.probe_floor.launches, probe_kernel.probe_blend_mma.launches
    floor, mma = probe_kernel.probe_floor(*case), probe_kernel.probe_blend_mma(*case)
    torch.cuda.synchronize()
    assert (probe_kernel.probe_floor.launches, probe_kernel.probe_blend_mma.launches) == (before[0] + 1, before[1] + 1)
    bound = 1e-5 * probe_kernel.probe_floor_plain(case[0].abs(), *case[1:])
    assert ((floor - probe_kernel.probe_floor_plain(*case)).abs() <= bound + 1e-30).all()
    compare_blend(mma, tile_raster2.tile_blend_plain(*case), case[3], "probe_blend_mma kernel")


@pytest.mark.cuda
@pytest.mark.parametrize("opacity", LONG_OPACITIES)
def test_probe_kernels_on_runs_of_several_segments(cuda_device, opacity):
    """Runs of up to 16,900 lanes, which both kernels cut into segments of
    kernel 2.1's length (pixels that stop in the first segment, in a
    later one and never, crossing every cut): chip_smoke.check_probe_case
    holds the floor (FLOOR_RTOL, the same on a second call) and the
    variant (compare_blend against the plain blend and against the plain
    repetition of its split algebra, bit-equal on a repeat)."""
    check_probe_case(long_blend_case(1, cuda_device, opacity), f"long runs, opacity {opacity}", split=True)


@pytest.mark.cuda
def test_train_steps_with_object_loss_match_cpu(cuda_device):
    """Two train steps with lambda_reg = 0.1 on a small scene with actors,
    the second at densify_until_iter (the actors rendered alone for the
    object-opacity loss), on the card and on the CPU with the same draws:
    gradients, parameters, moments and statistics within the CPU tests'
    tolerances (chip_smoke.grads_close and params_close)."""
    small_step_check(cuda_device, lambda_reg=0.1)


@pytest.mark.cuda
def test_runner_training_matches_cpu(cuda_device):
    """20 iterations of runner.training on a small Waymo-format sequence
    (nothing drawn; the opacity reset at 10, the object-opacity loss from
    15), on the card and on the CPU: logged losses, saved parameters,
    step counts and alive rows within the CPU tests' tolerances
    (chip_smoke.small_runner_check, params_close)."""
    small_runner_check(cuda_device)


def _cell1_cfg():
    """The full-scene recipe of the benchmark's cells 1 and 4
    (benchmark/configs/waymo_train_002.json, read as data) over the
    defaults."""
    import json

    from street_gaussians_torch.config import default_config

    def merge(dst, src):
        for k, v in src.items():
            if isinstance(v, dict):
                merge(dst[k], v)
            else:
                dst[k] = v
        return dst

    with open(os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "benchmark", "configs",
                           "waymo_train_002.json")) as f:
        return merge(default_config(), json.load(f)["recipe"])


@pytest.mark.cuda
def test_every_host_sync_lies_in_a_sync_span(cuda_device, tmp_path):
    """Traced train steps of the full-scene recipe (sky, LiDAR depth,
    actors with flips) on a small synthetic scene: one that ends in a
    densify round, one in a densify round and an opacity reset, one past
    densify_until_iter (the object render), then an eval render with the
    sky table: every cudaStreamSynchronize / cudaDeviceSynchronize they
    make lies inside a `sync/` span of its own thread (utils.trace)."""
    import dataclasses

    from street_gaussians_torch import train as ttrain_cli
    from street_gaussians_torch.data.dataset import Scene
    from street_gaussians_torch.models.sky_cubemap import build_sky_table
    from street_gaussians_torch.runner import make_eval_render
    from street_gaussians_torch.train_lib import (
        densify_cadence,
        make_densify_fn,
        make_reset_opacity_fn,
        make_train_step,
    )
    from street_gaussians_torch.utils import trace

    cell = ttrain_cli.bench_train_cell(cuda_device, num_bkgd=20_000, num_actors=2, H=266, W=400, sky_resolution=64)
    cfg = _cell1_cfg()
    sc = cell.scene
    step_fn = make_train_step(cfg, sc.table, sc.pose_data, cell.opts)
    densify_fn, reset_fn = make_densify_fn(cfg, sc.table), make_reset_opacity_fn()
    gen = torch.Generator(device=cuda_device).manual_seed(0)

    def step(state, iteration):
        state, _ = step_fn(dataclasses.replace(state, step=iteration - 1), cell.frame, cell.gt, gen)
        return densify_cadence(cfg, state, state.step, densify_fn, reset_fn, gen)[0]

    scene = Scene(table=sc.table, params_init=cell.state.params.gaussians, aux_init=cell.state.aux,
                  pose_data=sc.pose_data, pose_params_init=cell.state.params.actor_pose, train_views=[],
                  test_views=[], metadata={})
    render = make_eval_render(cfg, scene)
    with torch.no_grad():
        sky_table = build_sky_table(cell.state.params.sky.cubemap)
    state = step(cell.state, 10_001)  # the kernels built, every shape warm
    render(state.params, state.aux, cell.frame, sky_table=sky_table)
    torch.cuda.synchronize()
    with trace.profiler(cuda_device) as prof:
        with torch.profiler.record_function("checked"):
            for it in (10_100, 12_000, 30_001):
                state = step(state, it)
            render(state.params, state.aux, cell.frame, sky_table=sky_table)
        torch.cuda.synchronize()
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    ev = trace.load_events(path)
    (win,) = [e for e in ev if e.get("cat") == "user_annotation" and e.get("name") == "checked"]
    syncs = [y for y in trace.host_syncs(ev) if win["ts"] <= y["ts"] <= win["ts"] + win["dur"]]
    spans = trace.host_spans(ev)
    outside = [y for y in syncs if not any(s["tid"] == y["tid"] and s["ts"] <= y["ts"] <= s["ts"] + s["dur"]
                                           for s in spans)]
    assert len(syncs) > 100 and not outside, (len(syncs), outside[:5])
    assert {"densify", "object_render", "sync/densify_fill", "sync/lr_scalars", "sync/sky_constants"} <= {
        s["name"] for s in trace.host_spans(ev, "")}



@pytest.mark.cuda
def test_static_sh3_step_syncs_lie_in_sync_spans(cuda_device):
    """A traced train step of 3D Gaussian splatting's recipe at SH degree
    3 on a small static scene (benchmark/configs/mipnerf360_garden.json's
    garden at a toy size, built as the benchmark's cell builds it: one
    cloud, no actors, no sky): every host sync lies inside a `sync/`
    span of its own thread, the `sh` span opens inside `screen_space`
    and `sh_bwd` inside `backward`, the step launches the SH colour's
    forward and backward kernels once each, and utils.trace lists `sh`,
    `sh_bwd` and `grad_allreduce`."""
    import copy
    import json

    from benchmark.harness import orbit
    from benchmark.harness.orbit_scene import make_scene, make_truth, toy_config
    from street_gaussians_torch.ops.sh_color import sh_color
    from street_gaussians_torch.train_lib import Draws, make_train_step
    from street_gaussians_torch.utils import trace

    assert {"sh", "sh_bwd", "grad_allreduce"} <= set(trace.SPANS)
    with open(os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "benchmark", "configs",
                           "mipnerf360_garden.json")) as f:
        cfg = json.load(f)
    recipe = copy.deepcopy(cfg["recipe"])
    recipe["render"].update(instance_capacity=1 << 20, max_instance_capacity=1 << 20)
    scene = make_scene(toy_config(cfg["scene"], width=320, rows=40_000, views=9), 2**31 + 29, cuda_device)
    i = scene.train_views[0]
    prog = orbit.build(scene, recipe, {i: make_truth(scene, scene.views[i], cuda_device)}, cuda_device)
    step_fn = make_train_step(prog.cfg, prog.table, None, prog.opts_train)
    draws = Draws(torch.zeros(scene.capacity, dtype=torch.bool, device=cuda_device), None)
    state, sc = step_fn(prog.state, prog.frames[i], prog.truths[i], draws=draws)  # every shape warm
    assert int(sc["overflow"]) == 0
    torch.cuda.synchronize()
    launches = (sh_color.launches, sh_color.bwd_launches)
    with trace.profiler(cuda_device) as prof:
        with torch.profiler.record_function("checked"):
            state, _ = step_fn(state, prog.frames[i], prog.truths[i], draws=draws)
        torch.cuda.synchronize()
    assert (sh_color.launches - launches[0], sh_color.bwd_launches - launches[1]) == (1, 1)
    path = os.path.join(os.environ.get("TMPDIR", "/tmp"), f"static_sh3_trace_{os.getpid()}.json")
    prof.export_chrome_trace(path)
    ev = trace.load_events(path)
    os.unlink(path)
    (win,) = [e for e in ev if e.get("cat") == "user_annotation" and e.get("name") == "checked"]
    syncs = [y for y in trace.host_syncs(ev) if win["ts"] <= y["ts"] <= win["ts"] + win["dur"]]
    spans = trace.host_spans(ev)
    outside = [y for y in syncs if not any(s["tid"] == y["tid"] and s["ts"] <= y["ts"] <= s["ts"] + s["dur"]
                                           for s in spans)]
    assert syncs and not outside, (len(syncs), outside[:5])
    ranges = {n: [e for e in trace.host_spans(ev, n) if e["name"] == n]
              for n in ("sh", "screen_space", "sh_bwd", "backward")}
    for inner, outer in (("sh", "screen_space"), ("sh_bwd", "backward")):
        assert len(ranges[inner]) == 1 and any(s["ts"] <= ranges[inner][0]["ts"] and
                                               ranges[inner][0]["ts"] + ranges[inner][0]["dur"] <= s["ts"] + s["dur"]
                                               for s in ranges[outer]), inner


# ---------------------------------------------------------------- row-masked Adam


ADAM_ROWS = 5003  # a row count that is neither a multiple of 4 nor of the kernel's 4,096-float chunk
ADAM_SHAPES = {1: (1,), 3: (3,), 4: (4,), 9: (3, 3), 15: (5, 3), 45: (15, 3)}  # row widths as the leaves hold them


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))


def _adam_case(case: str, dev):
    """(params, grads, AdamState, lr, mask) of one card test case, drawn
    on the CPU from a fixed seed."""
    from street_gaussians_torch.optim.adam import AdamState

    gen = torch.Generator().manual_seed(sum(map(ord, case)))
    rand = lambda *shape: torch.rand(shape, generator=gen)  # noqa: E731
    randn = lambda *shape: torch.randn(shape, generator=gen)  # noqa: E731
    params, grads, mu, nu, count, lr, mask = {}, {}, {}, {}, {}, {}, {}

    def leaf(name, shape, cnt, lr_k, m=None, offset=0):
        n = int(np.prod(shape))
        for tree, x in ((params, randn(n)), (grads, randn(n) * 1e-3 * (rand(n) > 0.1)),
                        (mu, randn(n) * 1e-4), (nu, rand(n) * 1e-6)):
            # offset 1: a contiguous view 4 bytes into its storage, not 16-byte aligned
            tree[name] = torch.cat([torch.zeros(offset), x]).to(dev)[offset:].view(shape)
        count[name], lr[name], mask[name] = cnt.to(dev), lr_k, m

    rows = 2**24 if case == "every_count" else ADAM_ROWS
    # counts of 0-40, a tenth of the rows at 0; the mask off on a fifth
    # of them, so some rows never stepped stay at 0
    cnt = torch.floor(rand(rows) * 41) * (rand(rows) > 0.1)
    on = rand(rows) > 0.2
    lrs = [lambda: (rand(rows) * 1e-3).to(dev), lambda: 1.6e-4, lambda: 2.5e-3]
    scalar_leaves = (("actor_pose.opt_trans", (85, 6, 3), 7.0, 4.1e-4),
                     ("actor_pose.opt_rots", (85, 6, 1), 7.0, 0.0),
                     ("sky.cubemap", (6, 64, 64, 3), 0.0, 1e-2),
                     ("color_correction.affine", (303, 3, 4), 12345.0, 5e-4))
    if case in ("rows_bool", "unaligned"):
        m = on.to(dev) if case == "rows_bool" else None
        for i, (w, shape) in enumerate(ADAM_SHAPES.items()):
            leaf(f"gaussians.w{w}", (rows, *shape), cnt, lrs[i % 3](), m, offset=int(case == "unaligned"))
    elif case == "scalar_counts":
        # a sky-cubemap-shaped 4-D leaf and small pose leaves: scalar counts, no mask
        for name, shape, c, lr_k in scalar_leaves:
            leaf(name, shape, torch.tensor(c), lr_k)
    elif case == "every_count":
        # one float a row; every count from 0 to 2^24 - 1, each row on:
        # the bias corrections' powf at every integer step
        leaf("gaussians.opacity_logit", (rows, 1), torch.arange(rows, dtype=torch.float32), lrs[0](),
             torch.ones(rows, dtype=torch.bool, device=dev))
    elif case == "strided_grad":
        # a table as the semantics step's: the Gaussian leaves, the
        # semantic leaf's gradient as autograd gives it ([rows, 20]
        # transposed, so the wrapper copies it), then the scalar-count
        # leaves, a sky-sized cubemap (3 x 6 faces of 1024^2) among them,
        # whose outputs are allocated after the copy
        for i, (w, shape) in enumerate(ADAM_SHAPES.items()):
            leaf(f"gaussians.w{w}", (rows, *shape), cnt, lrs[i % 3](), on.to(dev))
        leaf("gaussians.semantic", (rows, 20), cnt, lrs[0](), on.to(dev))
        grads["gaussians.semantic"] = grads["gaussians.semantic"].t().contiguous().t()
        for name, shape, c, lr_k in scalar_leaves:
            leaf(name, (3, 6 * 1024 * 1024) if name == "sky.cubemap" else shape, torch.tensor(c), lr_k)
    elif case == "most_leaves":
        for i in range(32):
            leaf(f"leaf{i}", (ADAM_ROWS + i, 1 + i % 5), cnt[:1].clone().reshape(()) + i, 1e-3 * (i + 1))
    return params, grads, AdamState(mu=mu, nu=nu, count=count), lr, mask


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["rows_bool", "unaligned", "scalar_counts", "every_count", "strided_grad",
                                  "most_leaves"])
def test_adam_kernel_is_bit_equal_to_plain(cuda_device, case):
    """csrc/adam.cu against optim.adam's plain version, bit for bit:
    row widths 1, 3, 4, 9, 15, 45 over 5,003 rows (numel not a multiple
    of 4, rows not of the chunk), masks with rows off, rows whose count
    is 0, per-row and float lr; leaves 4 bytes off 16-byte alignment (the
    scalar path); scalar counts on a 4-D sky-shaped leaf; every count to
    2^24; a transposed gradient (the semantic leaf's layout) amid the
    leaves of a step, called 5 times; the 32 leaves a launch takes. The
    inputs are left as they were, and a call launches once."""
    from street_gaussians_torch.optim import adam

    params, grads, state, lr, mask = _adam_case(case, cuda_device)
    before = [t.clone() for tree in (params, grads, state.mu, state.nu, state.count) for t in tree.values()]
    want_p, want = adam.adam_update_plain(params, grads, state, lr, mask)
    for call in range(5 if case == "strided_grad" else 1):
        launches = adam.adam_update.launches
        got_p, got = adam.adam_update(params, grads, state, lr, mask)
        torch.cuda.synchronize()
        assert adam.adam_update.launches - launches == 1
        after = [t for tree in (params, grads, state.mu, state.nu, state.count) for t in tree.values()]
        assert all(_same_bits(a, b) for a, b in zip(before, after))
        for k in params:
            for what, a, b in (("param", got_p[k], want_p[k]), ("mu", got.mu[k], want.mu[k]),
                               ("nu", got.nu[k], want.nu[k]), ("count", got.count[k], want.count[k])):
                if not _same_bits(a, b):
                    ulp = (a.view(torch.int32).long() - b.view(torch.int32).long()).abs().max()
                    raise AssertionError(f"{case} call {call} {k} {what}: not bit-equal, "
                                         f"largest difference {int(ulp)} ulp")
        del got_p, got
    assert any(bool((p != want_p[k]).any()) for k, p in params.items())


@pytest.mark.cuda
def test_adam_kernel_rejects_what_it_does_not_take(cuda_device):
    """A CUDA leaf the kernel does not take raises (no fallback): float64,
    non-contiguous, a mask beside a scalar count, leaves on two devices,
    more leaves than a launch takes."""
    from street_gaussians_torch.optim import adam

    params, grads, state, lr, mask = _adam_case("rows_bool", cuda_device)
    k = "gaussians.w3"
    for bad in ({**params, k: params[k].double()},
                {**params, k: params[k].t().contiguous().t()},
                {**params, k: params[k].cpu()}):
        with pytest.raises(ValueError):
            adam.adam_update(bad, grads, state, lr, mask)
    scalar = state._replace(count={**state.count, k: state.count[k][0]})
    with pytest.raises(ValueError, match="scalar count"):
        adam.adam_update(params, grads, scalar, lr, mask)
    params, grads, state, lr, mask = _adam_case("most_leaves", cuda_device)
    params["one_more"], grads["one_more"] = params["leaf0"], grads["leaf0"]
    for tree in (state.mu, state.nu, state.count, lr, mask):
        tree["one_more"] = tree["leaf0"]
    with pytest.raises(ValueError, match="at most 32"):
        adam.adam_update(params, grads, state, lr, mask)


@pytest.mark.cuda
def test_train_step_takes_one_adam_launch_and_no_more_syncs(cuda_device, monkeypatch, tmp_path):
    """A traced train step of cell 1's recipe (sky, LiDAR depth, actors)
    on a small synthetic scene launches the Adam kernel once, and makes
    as many host syncs as the same step with the plain Adam."""
    import dataclasses

    from street_gaussians_torch import train as ttrain_cli
    from street_gaussians_torch import train_lib
    from street_gaussians_torch.optim import adam
    from street_gaussians_torch.utils import trace

    cell = ttrain_cli.bench_train_cell(cuda_device, num_bkgd=20_000, num_actors=2, H=266, W=400, sky_resolution=64)
    cfg = _cell1_cfg()
    step_fn = train_lib.make_train_step(cfg, cell.scene.table, cell.scene.pose_data, cell.opts)
    state = dataclasses.replace(cell.state, step=10_000)

    def traced_step(name):
        gen = torch.Generator(device=cuda_device).manual_seed(0)
        step_fn(state, cell.frame, cell.gt, gen)  # every shape warm
        torch.cuda.synchronize()
        launches = adam.adam_update.launches
        gen = torch.Generator(device=cuda_device).manual_seed(0)
        with trace.profiler(cuda_device) as prof:
            with torch.profiler.record_function("checked"):
                step_fn(state, cell.frame, cell.gt, gen)
            torch.cuda.synchronize()
        path = str(tmp_path / f"{name}.json")
        prof.export_chrome_trace(path)
        ev = trace.load_events(path)
        (win,) = [e for e in ev if e.get("cat") == "user_annotation" and e.get("name") == "checked"]
        syncs = [y for y in trace.host_syncs(ev) if win["ts"] <= y["ts"] <= win["ts"] + win["dur"]]
        return len(syncs), adam.adam_update.launches - launches

    syncs, launches = traced_step("kernel")
    assert launches == 1
    monkeypatch.setattr(train_lib, "adam_update", adam.adam_update_plain)
    plain_syncs, plain_launches = traced_step("plain")
    assert plain_launches == 0 and syncs == plain_syncs > 0, (syncs, plain_syncs)


def test_every_source_is_built_by_name():
    sources = {f[:-3] for f in os.listdir(_build.CSRC_DIR) if f.endswith(".cu")}
    assert sources == set(_build.ALL_SOURCES)
    for name in ("fill", "tile_blend_table", "tile_blend_table_bwd", "probe_blend", "adam"):
        assert "-fmad=false" in _build.nvcc_flags(name)


def test_library_name_tracks_source_and_flags():
    """The built library's name changes with the source text and with
    the nvcc flags, so neither change can load a stale library."""
    src = b"extern \"C\" int f() { return 0; }"
    flags = _build.nvcc_flags("tile_blend")
    base = _build.library_name(src, "tile_blend", flags)
    assert base.startswith("libtile_blend-") and base.endswith(".so")
    assert _build.library_name(src, "tile_blend", list(flags)) == base
    assert _build.library_name(src + b" ", "tile_blend", flags) != base
    assert _build.library_name(src, "tile_blend", flags + ["-lineinfo"]) != base
    assert "-fmad=false" in flags and "-fmad=false" not in _build.nvcc_flags("segsum")
    assert _build.library_path("segsum").startswith(_build.BUILD_DIR)


def test_library_name_tracks_headers_and_variants():
    """A library is built from its source and the headers under csrc/,
    and a variant with more nvcc flags gets a name of its own."""
    text = _build.source_bytes("tile_blend")
    with open(_build.source_path("tile_blend"), "rb") as f:
        assert text.startswith(f.read())
    for header in ("blend_common.cuh", "block_times.cuh"):
        with open(os.path.join(_build.CSRC_DIR, header), "rb") as f:
            assert f.read() in text
    probe = ("-DSG_BLOCK_TIMES",)
    assert _build.nvcc_flags("tile_blend", probe)[-1] == "-DSG_BLOCK_TIMES"
    assert _build.library_path("tile_blend", probe) != _build.library_path("tile_blend")


# ---------------------------------------------------------------- the SH colour


@pytest.mark.cuda
@pytest.mark.parametrize("K", [1, 4, 9, 16])
@pytest.mark.parametrize("F", [1, 5])
@pytest.mark.parametrize("actors", [None, 0.4])
def test_sh_color_kernels_match_plain(cuda_device, K, F, actors):
    """csrc/sh_color.cu (forward and backward, one launch each) against
    ops.sh_color's plain version on 5,003 rows (not a multiple of the
    kernel's 128-row block): rgb and the gradients of means3d,
    cam_center, feat_dc and feat_rest from torch.autograd.grad, within
    chip_smoke.SH_ATOL_SCALED of each output's largest |value| (the two
    sum a row's terms in other orders, the kernel with fused
    multiply-adds); at the full degree and with the background one
    degree lower (masked bands, whose feat_rest gradient must be exactly
    0); a row on the camera centre and one whose colour is exactly 0
    before the clamp (chip_smoke.sh_color_case). Without actors no t_row
    or is_actor (a single cloud's call); with them 40% actor rows and
    the coefficient arrays 4 bytes off 16-byte alignment."""
    from chip_smoke import check_sh_color, sh_color_case

    case = sh_color_case(5003, K, F, actors, cuda_device, seed=K * 10 + F, offset=int(actors is not None))
    deg = math.isqrt(K) - 1
    for degs in {(deg, deg), (max(deg - 1, 0), deg)}:
        check_sh_color(case, degs, f"K = {K}, F = {F}, actors {actors}, degrees {degs}")


@pytest.mark.cuda
def test_sh_color_kernel_rejects_what_it_does_not_take(cuda_device):
    """A CUDA input the kernel does not take raises (no fallback):
    float64 coefficients, 25 coefficients (degree 4), a float is_actor,
    the camera centre on the host."""
    from chip_smoke import sh_color_case
    from street_gaussians_torch.ops import sh_color as shc

    means3d, center, feat_dc, feat_rest, t_row, is_actor = sh_color_case(300, 16, 5, 0.4, cuda_device)
    for bad in ((means3d, center, feat_dc.double(), feat_rest, t_row, is_actor),
                (means3d, center, feat_dc, torch.zeros(300, 24, 3, device=cuda_device), t_row, is_actor),
                (means3d, center, feat_dc, feat_rest, t_row, is_actor.float()),
                (means3d, center.cpu(), feat_dc, feat_rest, t_row, is_actor)):
        with pytest.raises(ValueError):
            shc.sh_color(*bad, 3, 3)


# ---------------------------------------------------------------- tile bands and camera ranks


SMALL_SCENE = dict(sky_resolution=16, num_bkgd=600, num_actors=2, H=64, W=96)


@pytest.mark.cuda
@pytest.mark.parametrize("H,D", [(64, 2), (64, 4), (32, 4)])
def test_bands_match_the_whole_frame(cuda_device, H, D):
    """A frame in D tile-row bands in turn against the whole frame at
    the blend tolerances (sky_downsample 1); at 32 rows in 4 bands the
    bands 2 and 3 are empty and still launch the blend (4 launches)."""
    import dataclasses

    from chip_smoke import compare_frames
    from street_gaussians_torch import serve
    from street_gaussians_torch.models.renderer import render_frame
    from street_gaussians_torch.parallel import tiles

    scene, params = serve.bench_scene(seed=3, device=cuda_device, **{**SMALL_SCENE, "H": H})
    opts = dataclasses.replace(serve.SERVE_OPTS, sky_downsample=1)
    frame = scene.frames[1]
    with torch.no_grad():
        whole = render_frame(params, scene.aux, scene.table, scene.pose_data, frame, serve.SERVE_STEP, opts=opts)
        before = tile_raster2.tile_blend_instances.launches
        got = tiles.make_row_sharded_render(scene.table, scene.pose_data, opts, D)(params, scene.aux, frame)
    torch.cuda.synchronize()
    assert tile_raster2.tile_blend_instances.launches == before + D
    compare_frames(got, whole, f"{H} rows in {D} bands")
    assert torch.equal(got["radii"], whole["radii"])
    assert int(got["num_instances"]) == int(whole["num_instances"]) and int(got["overflow"]) == 0


@pytest.mark.cuda
def test_two_camera_ranks_share_one_card(cuda_device, tmp_path):
    """Two spawned ranks on cuda:0 (Gloo), one view each of a small
    bench cell: one camera-parallel step in one band and in two leaves
    the two ranks' states bit-equal, every kernel launched once a band."""
    from chip_smoke import camera_rank

    torch.multiprocessing.spawn(camera_rank, args=(2, str(tmp_path), SMALL_SCENE), nprocs=2, join=True)
    ranks = [torch.load(str(tmp_path / f"rank{r}.pt"), weights_only=False) for r in range(2)]
    assert ranks[0]["initial_hash"] == ranks[1]["initial_hash"]
    for D in (1, 2):
        a, b = (r["steps"][D] for r in ranks)
        assert a["hash"] == b["hash"] and a["overflow"] == b["overflow"] == 0
        for r in (a, b):
            n = r["launches"]
            assert (n["tile_blend_instances"], n["tile_blend_bwd"], n["segment_rowsum"]) == (D, D, 2 * D), n


@pytest.mark.cuda
@pytest.mark.parametrize("G,T", [(2, 1), (4, 1), (2, 2)])
def test_gauss_sharded_render_matches_the_whole_frame(cuda_device, G, T):
    """The table's rows composed in G blocks in turn and joined (and the
    joined screen in T tile-row bands): the integer outputs and radii
    equal the whole frame's, the images bit-equal without bands and at
    the blend tolerances with them (sky_downsample 1)."""
    import dataclasses

    from chip_smoke import compare_frames
    from street_gaussians_torch import serve
    from street_gaussians_torch.models.renderer import render_frame
    from street_gaussians_torch.parallel import gauss

    scene, params = serve.bench_scene(seed=3, device=cuda_device, **SMALL_SCENE)
    opts = dataclasses.replace(serve.SERVE_OPTS, sky_downsample=1)
    frame = scene.frames[1]
    with torch.no_grad():
        whole = render_frame(params, scene.aux, scene.table, scene.pose_data, frame, serve.SERVE_STEP, opts=opts)
        before = tile_raster2.tile_blend_instances.launches
        got = gauss.make_gauss_sharded_render(scene.table, scene.pose_data, opts, G, tile_shards=T)(
            params, scene.aux, frame)
    torch.cuda.synchronize()
    assert tile_raster2.tile_blend_instances.launches == before + T
    assert torch.equal(got["radii"], whole["radii"])
    for k in ("num_instances", "overflow", "overflow_instance", "overflow_tile"):
        assert int(got[k]) == int(whole[k]), k
    if T == 1:
        for k in ("rgb", "depth", "acc", "T"):
            assert torch.equal(got[k], whole[k]), k
    compare_frames(got, whole, f"{G} row blocks x {T} bands")


@pytest.mark.cuda
def test_tile_path_matches_the_oracle(cuda_device):
    """rasterize (kernels 2.1, 2.3) and its gradients (2.2, 2.4) against
    the per-pixel oracle, and render_gaussians with both colour sources,
    at 300 Gaussians on 48x64 (chip_smoke.oracle_phase raises on any
    disagreement)."""
    res = oracle_phase(cuda_device, H=48, W=64, n=300)
    assert res["launches"]["tile_blend_instances"] == 5 and res["launches"]["tile_blend_bwd"] == 1


def _top_laser_frame():
    """A frame of data.synthetic_tfrecord with Waymo's TOP laser (64 x
    2650, explicit beams) and a side laser (200 x 600, a range), toy
    cameras."""
    from street_gaussians_torch.data import synthetic_tfrecord as st
    from street_gaussians_torch.data import waymo_proto as wp

    sizes = {n: (48, 72) for n in range(1, 6)}
    return wp.Frame(st.encode_frame(0, sizes, {1: (64, 2650), 2: (200, 600)}, [])), wp


@pytest.mark.cuda
def test_project_to_pointcloud_on_the_card_matches_cpu(cuda_device):
    """The range-image projection in float64 on the card against the CPU
    device: the float32 points within 1 ULP (chip_smoke step 14's rule),
    the attributes equal."""
    from chip_smoke import f32_ulps

    frame, wp = _top_laser_frame()
    for laser in frame.lasers:
        ri = laser.ri_return1.range_image()
        calib = wp.get_by_name(frame.laser_calibrations, laser.name)
        got, attrs = wp.project_to_pointcloud(frame, ri, calib, device=cuda_device)
        want, want_attrs = wp.project_to_pointcloud(frame, ri, calib, device="cpu")
        assert got.shape == want.shape and got.shape[0] > 0
        assert f32_ulps(got.astype(np.float32), want.astype(np.float32)) <= 1
        np.testing.assert_array_equal(attrs, want_attrs)


@pytest.mark.cuda
def test_lidar_depth_on_the_card_matches_cpu(cuda_device):
    """generate_lidar_depth.depth_map (float64 depths, scatter-min) of the
    TOP laser's points into a 1280 x 1920 image on the card and on the
    CPU: masks equal, values within 1 float32 ULP."""
    from chip_smoke import f32_ulps
    from street_gaussians_torch.data import synthetic_tfrecord as st
    from street_gaussians_torch.script.waymo.generate_lidar_depth import depth_map

    frame, wp = _top_laser_frame()
    laser = next(x for x in frame.lasers if x.name == 1)
    ri = laser.ri_return1.range_image()
    pts, _ = wp.project_to_pointcloud(frame, ri, wp.get_by_name(frame.laser_calibrations, 1), device="cpu")
    pts = pts.astype(np.float32)
    intr, ext = st.camera_calibration(1, 1280, 1920)
    opencv = np.array([[0.0, 0.0, 1.0, 0.0], [-1.0, 0.0, 0.0, 0.0], [0.0, -1.0, 0.0, 0.0], [0.0, 0.0, 0.0, 1.0]])
    w2c = np.linalg.inv(ext @ opencv)
    cam = pts.astype(np.float64) @ w2c[:3, :3].T + w2c[:3, 3]
    with np.errstate(divide="ignore", invalid="ignore"):
        uv = np.stack([intr[0] * cam[:, 0] / cam[:, 2] + intr[2], intr[1] * cam[:, 1] / cam[:, 2] + intr[3]], -1)
    keep = (cam[:, 2] > 0) & (uv[:, 0] >= 0) & (uv[:, 0] < 1920) & (uv[:, 1] >= 0) & (uv[:, 1] < 1280)
    coords = uv[keep].astype(np.int32)
    out = {}
    for dev in (cuda_device, torch.device("cpu")):
        out[dev.type] = depth_map(torch.as_tensor(pts[keep], device=dev), coords, w2c, 1280, 1920)
    (mg, vg), (mc, vc) = out["cuda"], out["cpu"]
    assert mg.sum() > 1000
    np.testing.assert_array_equal(mg, mc)
    assert f32_ulps(vg, vc) <= 1
