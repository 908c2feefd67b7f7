"""The scan formulation of binning, as the port computed it before
ops/fill.expand_instances: the run expansion's channels
(fill.expand_runs), each slot's offset in its run from a running maximum
(torch.cummax) over all the slots, and a live row's rank in its tile
from a second one. The tests' oracle only: the port scans no more."""

import torch

from street_gaussians_torch.ops import binning, fill


def scan_instances(vals, offs, total, num_slots, num_ids, grid_x, grid_y):
    """(tile id, gaussian id) per slot, as fill.expand_instances returns
    them."""
    dev = vals.device
    i32 = torch.int32
    num_tiles = grid_x * grid_y
    filled = fill.expand_runs(vals, offs, total, num_slots)
    gauss_i = filled[0].to(i32)
    if num_ids == 2:
        pr = filled[1].to(i32)
        rx = pr & 127
        ry = (pr >> 7) & 127
        rw = torch.clamp(pr >> 14, min=1)
    else:
        rx = filled[1].to(i32)
        ry = filled[2].to(i32)
        rw = torch.clamp(filled[3].to(i32), min=1)
    s = torch.arange(num_slots, dtype=i32, device=dev)
    # within-run offset: runs start where the expanded id changes
    prev_g = torch.cat([torch.full((1,), -1, dtype=i32, device=dev), gauss_i[:-1]])
    run_start = torch.cummax(torch.where(gauss_i != prev_g, s, 0), dim=0).values
    k = s - run_start
    tx = rx + k % rw
    ty = ry + k // rw
    live = s < total
    if vals.shape[0] > num_ids:
        mx_i, my_i, r2_i = filled[num_ids], filled[num_ids + 1], filled[num_ids + 2]
        px0 = tx.to(torch.float32) * 16.0
        py0 = ty.to(torch.float32) * 16.0
        dx = torch.minimum(torch.maximum(mx_i, px0), px0 + 15.0) - mx_i
        dy = torch.minimum(torch.maximum(my_i, py0), py0 + 15.0) - my_i
        live = live & (dx * dx + dy * dy <= r2_i)
    tile_id = torch.where(live, ty * grid_x + tx, num_tiles).to(i32)
    gauss_id = torch.where(live, gauss_i, -1).to(i32)
    return tile_id, gauss_id


def scan_rank(st, num_tiles):
    """Each sorted row's rank in its tile's run, from the last tile
    boundary at or before it (meaningful for live rows)."""
    i32 = torch.int32
    s = torch.arange(st.shape[0], dtype=i32, device=st.device)
    prev_t = torch.cat([torch.full((1,), -1, dtype=i32, device=st.device), st[:-1]])
    boundary = (st != prev_t) & (st < num_tiles)
    return s - torch.cummax(torch.where(boundary, s, 0), dim=0).values


def _sorted(screen, grid_x, grid_y, S, corner_cull):
    ex = binning.expand_inputs(screen, grid_x, grid_y, corner_cull)
    tile_id, gauss_id = scan_instances(ex.vals, ex.offs, ex.total, S, ex.num_ids, grid_x, grid_y)
    st, perm = torch.sort(tile_id, stable=True)
    queries = torch.arange(grid_x * grid_y + 1, dtype=torch.int32, device=st.device)
    tile_start = torch.clamp(torch.searchsorted(st, queries, side="left").to(torch.int32), max=S)
    return st, gauss_id[perm], tile_start, ex.total


def _counts(counts_all, total, S, tile_capacity):
    instance_overflow = torch.clamp(total - S, min=0)
    tile_overflow = torch.clamp(counts_all - tile_capacity, min=0).sum(dtype=torch.int32)
    return dict(tile_count=torch.clamp(counts_all, max=tile_capacity), num_instances=total,
                overflow=instance_overflow + tile_overflow, overflow_instance=instance_overflow,
                overflow_tile=tile_overflow)


def scan_bin_gaussians_instances(screen, grid_x, grid_y, S, tile_capacity, corner_cull=True):
    num_tiles = grid_x * grid_y
    st, sg, tile_start, total = _sorted(screen, grid_x, grid_y, S, corner_cull)
    keep = st < num_tiles
    if tile_capacity < S:
        keep = keep & (scan_rank(st, num_tiles) < tile_capacity)
    return binning.InstanceBinning(torch.where(keep, sg, -1), tile_start=tile_start[:-1],
                                   **_counts(tile_start[1:] - tile_start[:-1], total, S, tile_capacity))


def scan_bin_gaussians(screen, grid_x, grid_y, S, tile_capacity):
    _, sg, tile_start, total = _sorted(screen, grid_x, grid_y, S, corner_cull=False)
    counts = _counts(tile_start[1:] - tile_start[:-1], total, S, tile_capacity)
    r = torch.arange(tile_capacity, dtype=torch.int32, device=sg.device)
    rows = torch.clamp(tile_start[:-1, None] + r[None, :], max=S - 1).to(torch.int64)
    tile_gauss = torch.where(r[None, :] < counts["tile_count"][:, None], sg[rows], -1)
    return binning.TileBinning(tile_gauss, **counts)
