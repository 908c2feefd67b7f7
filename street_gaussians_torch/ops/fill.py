"""Run expansion (kernel A): per-gaussian values to per-instance slots.

Gaussian j owns the contiguous slot run [offs[j], offs[j+1]) (the last
run ends at `total`), so

    out[:, s] = vals[:, j]   for the unique j with offs[j] <= s < offs[j+1]

and 0 for slots no run covers, at and beyond `total` included.

Replaces street_gaussians_tpu/ops/fill.py::_kernel (an MXU select
matmul on the TPU) with `csrc/fill.cu`, which splits the merge of the
run ends with the slots into tiles of equal length, one search per tile
end (`merge_path_runs_plain` is that partition in plain PyTorch,
`expand_runs_partitioned` the expansion walked through it). Bound on
the H100: memory (read vals [C, N], write out [C, S]); the copy is exact
and deterministic, and the work is even however ragged the runs are.

`expand_instances` is the same merge with binning's derivation in its
last step: each slot's tile and Gaussian from its run's rect and its
offset in the run, s - offs[j] (no scan over the slots), the optional
corner cull applied; it writes two [S] int32 arrays. Binning calls it;
`expand_runs` stays for its contract, its tests and
script.search_times.

Both run the plain PyTorch version for a CPU tensor and the kernel for
a CUDA tensor.
"""

from __future__ import annotations

import ctypes

import torch

from street_gaussians_torch.kernels import _build

# more nvcc flags for the library: script/search_times.py sets a probe
# build here for the length of its measurement
BUILD_FLAGS: tuple = ()
# the kernel's block: threads, and merged items per thread
# (csrc/fill.cu FILL_THREADS, FILL_ITEMS)
FILL_THREADS = 256
FILL_ITEMS = 8


def _bind(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.expand_runs_f32.argtypes = [p, p, p, p, i, i, i, p]
    lib.expand_runs_f32.restype = ctypes.c_int
    lib.expand_instances_i32.argtypes = [p, p, p, p, p, i, i, i, i, i, i, p]
    lib.expand_instances_i32.restype = ctypes.c_int


def _check_args(vals, offs, total, num_slots):
    if vals.dim() != 2 or vals.dtype != torch.float32:
        raise ValueError(f"expand_runs: vals must be [C, N] float32, got {tuple(vals.shape)} {vals.dtype}")
    C, N = vals.shape
    if offs.shape != (N,) or offs.dtype != torch.int32:
        raise ValueError(f"expand_runs: offs must be [{N}] int32, got {tuple(offs.shape)} {offs.dtype}")
    if total.numel() != 1 or total.dtype != torch.int32:
        raise ValueError("expand_runs: total must be a scalar int32 tensor")
    if offs.device != vals.device or total.device != vals.device:
        raise ValueError("expand_runs: vals, offs and total must share a device")
    if N >= 2**24:
        # the JAX op routes integer channels (gaussian ids, packed rects)
        # through f32, exact only below 2^24; the port keeps its contract
        raise ValueError(
            f"expand_runs: {N} runs >= 2**24 — integer channels carried "
            "as f32 would round; shard the gaussian axis below 2^24"
        )
    if num_slots < 0:
        raise ValueError("expand_runs: num_slots must be >= 0")
    if N + num_slots >= 2**31 - 2**16:
        raise ValueError(f"expand_runs: {N} runs + {num_slots} slots >= 2**31 - 2**16")


def _slot_runs_plain(offs: torch.Tensor, total: torch.Tensor, num_slots: int):
    """Each slot s, its run (searchsorted over the run ends, clamped to
    the last run) and whether that run covers it. Needs N > 0."""
    N = offs.shape[0]
    s = torch.arange(num_slots, dtype=torch.int32, device=offs.device)
    ends = torch.cat([offs[1:], total.reshape(1).to(offs.dtype)])
    j = torch.searchsorted(ends, s, right=True)
    run = j.clamp(max=N - 1)
    return s, run, (j < N) & (offs[run] <= s)


def expand_runs_plain(
    vals: torch.Tensor, offs: torch.Tensor, total: torch.Tensor, num_slots: int
) -> torch.Tensor:
    """Plain PyTorch version: searchsorted over the run ends, then a
    gather. Same contract as `expand_runs`."""
    C, N = vals.shape
    if N == 0:
        return vals.new_zeros((C, num_slots))
    _, run, hit = _slot_runs_plain(offs, total, num_slots)
    return torch.where(hit[None, :], vals[:, run], vals.new_zeros(()))


def merge_path_runs_plain(offs: torch.Tensor, total: torch.Tensor, num_slots: int, diags: torch.Tensor):
    """The kernel's partition in plain PyTorch: for each diagonal d, the
    (run, slot) point (i, d - i) where the first d items of the merge
    of the run ends (offs[1:], then total) with the slots 0..S-1 are the
    ends of runs 0..i-1 and slots 0..d-i-1. Run i's end is item
    i + (slots before it) of the merge: a slot at or past the end comes
    after it."""
    N = offs.shape[0]
    ends = torch.cat([offs[1:], total.reshape(1).to(offs.dtype)]).long()
    pos = torch.arange(N, device=offs.device) + ends.clamp(0, num_slots)
    i = torch.searchsorted(pos, diags.long())
    return i, diags.long() - i


def expand_runs_partitioned(
    vals: torch.Tensor, offs: torch.Tensor, total: torch.Tensor, num_slots: int,
    threads: int = FILL_THREADS, items: int = FILL_ITEMS,
) -> torch.Tensor:
    """`expand_runs` walked as the kernel walks it, in plain PyTorch:
    each thread starts at its point of the partition and takes its
    `items` merged items in order, a run end moving it to the next run
    and a slot taking the current run (or none). Same contract and
    result as `expand_runs`; the main path never calls it."""
    _check_args(vals, offs, total, num_slots)
    C, N = vals.shape
    if N == 0:
        return vals.new_zeros((C, num_slots))
    dev = vals.device
    total_items = N + num_slots
    nt = -(-total_items // items)
    start = torch.clamp(torch.arange(nt, device=dev) * items, max=total_items)
    i, j = merge_path_runs_plain(offs, total, num_slots, start)
    ends = torch.cat([offs[1:], total.reshape(1).to(offs.dtype)]).long()
    offs_l = offs.long()
    run_of = torch.full((num_slots,), -1, dtype=torch.int64, device=dev)
    for k in range(items):
        live = start + k < total_items
        ic = i.clamp(max=N - 1)
        in_runs = i < N
        is_end = live & in_runs & ((j >= num_slots) | (ends[ic] <= j))
        is_slot = live & ~is_end
        hit = offs_l[ic] <= j
        slot = is_slot.nonzero().squeeze(1)
        run_of[j[slot]] = torch.where(in_runs & hit, i, -1)[slot]
        i, j = i + is_end, j + is_slot
    return torch.where(run_of[None, :] >= 0, vals[:, run_of.clamp(min=0)], vals.new_zeros(()))


def expand_runs(
    vals: torch.Tensor, offs: torch.Tensor, total: torch.Tensor, num_slots: int
) -> torch.Tensor:
    """vals: [C, N] f32 channel-major per-gaussian values (integer
    channels pre-converted to f32, exact below 2^24). offs: [N] int32
    non-decreasing run starts (exclusive cumsum of per-gaussian counts;
    zero-count gaussians give empty runs). total: scalar int32 tensor =
    offs[-1] + cnt[-1]. Returns [C, num_slots] f32."""
    _check_args(vals, offs, total, num_slots)
    if vals.device.type == "cpu":
        return expand_runs_plain(vals, offs, total, num_slots)
    _build.require_cuda(vals, "expand_runs")
    vals = vals.contiguous()
    offs = offs.contiguous()
    total = total.reshape(()).contiguous()
    C, N = vals.shape
    out = torch.empty((C, num_slots), dtype=torch.float32, device=vals.device)
    lib = _build.load("fill", _bind, BUILD_FLAGS)
    err = lib.expand_runs_f32(
        _build.ptr(vals), _build.ptr(offs), _build.ptr(total), _build.ptr(out),
        C, N, num_slots, _build.stream_of(vals),
    )
    _build.check(err, "expand_runs")
    expand_runs.launches += 1
    return out


expand_runs.launches = 0


def _check_instance_args(vals, offs, total, num_slots, num_ids, grid_x, grid_y):
    _check_args(vals, offs, total, num_slots)
    if num_ids not in (2, 4) or vals.shape[0] not in (num_ids, num_ids + 3):
        raise ValueError(
            f"expand_instances: vals must hold the id, 1 or 3 rect rows and 0 or 3 cull rows "
            f"(num_ids {num_ids}), got {vals.shape[0]} rows"
        )
    if num_ids == 2 and (grid_x >= 128 or grid_y >= 128):
        raise ValueError(f"expand_instances: a packed rect holds grids below 128 a side, got {grid_x}x{grid_y}")
    if grid_x * grid_y >= 2**31:
        raise ValueError("expand_instances: num_tiles >= 2**31")


def expand_instances_plain(
    vals: torch.Tensor, offs: torch.Tensor, total: torch.Tensor, num_slots: int,
    num_ids: int, grid_x: int, grid_y: int,
):
    """Plain PyTorch version: each slot's run from searchsorted, as in
    `expand_runs_plain`, then the same derivation as the kernel. Same
    contract as `expand_instances`."""
    _check_instance_args(vals, offs, total, num_slots, num_ids, grid_x, grid_y)
    i32 = torch.int32
    C, N = vals.shape
    num_tiles = grid_x * grid_y
    if N == 0:
        return (torch.full((num_slots,), num_tiles, dtype=i32, device=vals.device),
                torch.full((num_slots,), -1, dtype=i32, device=vals.device))
    s, run, live = _slot_runs_plain(offs, total, num_slots)
    v = vals[:, run]
    k = s - offs[run]
    if num_ids == 2:
        pr = v[1].to(i32)
        rx, ry, rw = pr & 127, (pr >> 7) & 127, torch.clamp(pr >> 14, min=1)
    else:
        rx, ry, rw = v[1].to(i32), v[2].to(i32), torch.clamp(v[3].to(i32), min=1)
    tx = rx + k % rw
    ty = ry + k // rw
    if C > num_ids:
        # distance from the center to the tile's pixel box
        # [16 tx, 16 tx + 15] x [16 ty, 16 ty + 15]
        mx, my, r2 = v[num_ids], v[num_ids + 1], v[num_ids + 2]
        px0 = tx.to(torch.float32) * 16.0
        py0 = ty.to(torch.float32) * 16.0
        dx = torch.minimum(torch.maximum(mx, px0), px0 + 15.0) - mx
        dy = torch.minimum(torch.maximum(my, py0), py0 + 15.0) - my
        live = live & (dx * dx + dy * dy <= r2)
    tile_id = torch.where(live, ty * grid_x + tx, num_tiles).to(i32)
    gauss_id = torch.where(live, v[0].to(i32), -1).to(i32)
    return tile_id, gauss_id


def expand_instances(
    vals: torch.Tensor, offs: torch.Tensor, total: torch.Tensor, num_slots: int,
    num_ids: int, grid_x: int, grid_y: int,
):
    """Binning's instances straight from the runs (ops/binning.expand_inputs
    makes the arguments). vals: [C, N] f32, the id, then the rect packed
    as x + (y << 7) + (w << 14) (num_ids 2, grids below 128 a side) or as
    x, y, w (num_ids 4), then optionally the corner cull's center x, y
    and squared radius. offs, total: as in `expand_runs`. Slot s of run
    j is the k-th tile, k = s - offs[j], of Gaussian j's rect, row-major
    over its width. Returns ([S] int32 tile id, [S] int32 gaussian id),
    num_tiles and -1 where no run covers the slot or the cull drops it."""
    if vals.device.type == "cpu":
        return expand_instances_plain(vals, offs, total, num_slots, num_ids, grid_x, grid_y)
    _check_instance_args(vals, offs, total, num_slots, num_ids, grid_x, grid_y)
    _build.require_cuda(vals, "expand_instances")
    vals = vals.contiguous()
    offs = offs.contiguous()
    total = total.reshape(()).contiguous()
    C, N = vals.shape
    tile_id = torch.empty((num_slots,), dtype=torch.int32, device=vals.device)
    gauss_id = torch.empty((num_slots,), dtype=torch.int32, device=vals.device)
    lib = _build.load("fill", _bind, BUILD_FLAGS)
    err = lib.expand_instances_i32(
        _build.ptr(vals), _build.ptr(offs), _build.ptr(total), _build.ptr(tile_id), _build.ptr(gauss_id),
        N, num_slots, num_ids, int(C > num_ids), grid_x, grid_x * grid_y, _build.stream_of(vals),
    )
    _build.check(err, "expand_instances")
    expand_instances.launches += 1
    return tile_id, gauss_id


expand_instances.launches = 0
