"""The port's CUDA kernels against their plain PyTorch versions, on the
card, and the kernel build's cache key. Without a CUDA card every test
marked `cuda` skips. This file imports no JAX, so it also runs where JAX
is absent:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import os

import numpy as np
import pytest
import torch

from chip_smoke import (
    LONG_OPACITIES,
    SEG_RTOL,
    compare_blend,
    compare_blend_bwd,
    live_lanes,
    long_blend_case,
    oracle_phase,
    random_blend_case,
    random_expand_case,
    random_table_case,
    small_runner_check,
    small_step_check,
    wide_blend_checks,
)
from street_gaussians_torch.kernels import _build
from street_gaussians_torch.ops import fill, rasterize, segsum, tile_raster, tile_raster2
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


def test_every_source_is_built_by_name():
    sources = {f[:-3] for f in os.listdir(_build.CSRC_DIR) if f.endswith(".cu")}
    assert sources == set(_build.ALL_SOURCES)
    for name in ("tile_blend_table", "tile_blend_table_bwd", "probe_blend"):
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
