"""Tile binning: per-Gaussian tile rects to depth-ordered, ragged
per-tile runs of one sorted instance array.

Port of street_gaussians_tpu/ops/binning.py:199-446
(`bin_gaussians_instances`). Order and integer outputs are the JAX
package's exactly: Gaussians are depth-sorted once (stable, by the
float32 bits of the depth), instances are enumerated in depth-rank
order through the run expansion (ops/fill.expand_runs, kernel A), and
one stable sort by tile id gives tile-major, depth-minor,
original-index-tertiary order.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from street_gaussians_torch.ops import fill as fill_lib
from street_gaussians_torch.ops.preprocess import GaussianScreenData


class InstanceBinning(NamedTuple):
    """Each tile owns the ragged run [tile_start, tile_start +
    tile_count) of rows of the (tile, depth)-sorted instance array."""

    inst_gauss: torch.Tensor  # [S] int32 gaussian index per sorted slot, -1 dropped
    tile_count: torch.Tensor  # [num_tiles] int32 valid instances per tile (clamped)
    tile_start: torch.Tensor  # [num_tiles] int32 first sorted row of the tile's run
    num_instances: torch.Tensor  # scalar: total generated (pre-drop)
    overflow: torch.Tensor  # scalar: dropped instances (either cause)
    overflow_instance: torch.Tensor  # scalar: dropped by instance_capacity
    overflow_tile: torch.Tensor  # scalar: dropped by tile_capacity


class ExpandInputs(NamedTuple):
    """The run expansion's inputs: per-gaussian channels in depth-rank
    order and their run starts."""

    vals: torch.Tensor  # [C, N] f32: gaussian id, rect channel(s), cull channels
    offs: torch.Tensor  # [N] int32 run starts
    total: torch.Tensor  # scalar int32: instances generated
    num_ids: int  # leading integer channels (id + packed or separate rect)


def expand_inputs(
    screen: GaussianScreenData, grid_x: int, grid_y: int, corner_cull: bool = True
) -> ExpandInputs:
    """Depth-sort the Gaussians and stack the channels each instance
    inherits from its Gaussian (binning.py:249-359)."""
    dev = screen.depth.device
    n = screen.depth.shape[0]
    i32 = torch.int32
    cnt0 = screen.tiles_touched

    # float32 bits of positive depths sort like the depths; culled rows last
    depth_bits = screen.depth.contiguous().view(i32)
    depth_key_n = torch.where(cnt0 > 0, depth_bits, torch.full((), 0x7FFFFFFF, dtype=i32, device=dev))

    cull_n = []
    if corner_cull:
        # alpha can reach 1/255 only within r2max of the center; lam_min
        # shrunk and r2max grown by ~1e-4 relative so rounding never
        # drops an instance the blend would keep. The keep-everything
        # sentinel is a finite 1e30 (inf * 0 would give NaN)
        ca, cb, cc = screen.conic.unbind(-1)
        lam_min = (
            0.5 * (ca + cc)
            - torch.sqrt(torch.clamp(0.25 * (ca - cc) ** 2 + cb * cb, min=0.0))
        ) * (1.0 - 1e-5)
        th = 1.0 / 255.0
        op = screen.opacity
        big = torch.full((), 1e30, dtype=torch.float32, device=dev)
        r2max = torch.where(
            op >= th,
            torch.where(
                lam_min > 0.0,
                torch.minimum(
                    2.0 * torch.log(torch.clamp(op, min=th) / th)
                    / torch.clamp(lam_min, min=1e-30)
                    * (1.0 + 1e-4)
                    + 1e-6,
                    big,
                ),
                big,
            ),
            torch.full((), -1.0, dtype=torch.float32, device=dev),
        )
        cull_n = [screen.mean2d[:, 0], screen.mean2d[:, 1], r2max]

    rect_min = screen.rect_min
    rwidth = screen.rect_max[:, 0] - rect_min[:, 0]
    if grid_x < 128 and grid_y < 128:
        ids = [rect_min[:, 0] + (rect_min[:, 1] << 7) + (rwidth << 14)]
    else:  # panorama-scale grids: separate rect columns
        ids = [rect_min[:, 0], rect_min[:, 1], rwidth]
    oid = torch.arange(n, dtype=i32, device=dev)

    _, order = torch.sort(depth_key_n, stable=True)
    cnt_s = cnt0[order]
    offs = torch.cumsum(cnt_s, dim=0, dtype=i32) - cnt_s
    total = (offs[-1] + cnt_s[-1]).reshape(())
    chans = [c[order].to(torch.float32) for c in [oid, *ids]] + [c[order] for c in cull_n]
    return ExpandInputs(torch.stack(chans, dim=0), offs, total, 1 + len(ids))


def bin_gaussians_instances(
    screen: GaussianScreenData,
    grid_x: int,
    grid_y: int,
    instance_capacity: int,
    tile_capacity: int,
    corner_cull: bool = True,
) -> InstanceBinning:
    """Instance-major binning with per-tile contiguous ragged runs.

    corner_cull: drop instances whose maximum possible alpha anywhere in
    their tile is provably < 1/255 (the blend's own keep test zeroes
    exactly these), with the JAX package's safety margins."""
    dev = screen.depth.device
    i32 = torch.int32
    num_tiles = grid_x * grid_y
    S = instance_capacity

    ex = expand_inputs(screen, grid_x, grid_y, corner_cull)
    total = ex.total
    filled = fill_lib.expand_runs(ex.vals, ex.offs, total, S)
    gauss_i = filled[0].to(i32)
    if ex.num_ids == 2:
        pr = filled[1].to(i32)
        rx = pr & 127
        ry = (pr >> 7) & 127
        rw = torch.clamp(pr >> 14, min=1)
    else:
        rx = filled[1].to(i32)
        ry = filled[2].to(i32)
        rw = torch.clamp(filled[3].to(i32), min=1)

    s = torch.arange(S, dtype=i32, device=dev)
    inst_valid = s < total
    # within-run offset: runs start where the expanded id changes
    prev_g = torch.cat([torch.full((1,), -1, dtype=i32, device=dev), gauss_i[:-1]])
    run_start = torch.cummax(torch.where(gauss_i != prev_g, s, 0), dim=0).values
    k = s - run_start
    tx = rx + k % rw
    ty = ry + k // rw
    live = inst_valid
    if corner_cull:
        # distance from the center to the tile's pixel box
        # [16 tx, 16 tx + 15] x [16 ty, 16 ty + 15]
        nid = ex.num_ids
        mx_i, my_i, r2_i = filled[nid], filled[nid + 1], filled[nid + 2]
        px0 = tx.to(torch.float32) * 16.0
        py0 = ty.to(torch.float32) * 16.0
        dx = torch.minimum(torch.maximum(mx_i, px0), px0 + 15.0) - mx_i
        dy = torch.minimum(torch.maximum(my_i, py0), py0 + 15.0) - my_i
        live = live & (dx * dx + dy * dy <= r2_i)
    tile_id = torch.where(live, ty * grid_x + tx, num_tiles).to(i32)
    gauss_id = torch.where(live, gauss_i, -1).to(i32)

    # one stable tile sort: enumeration order is already depth order
    st, perm = torch.sort(tile_id, stable=True)
    sg = gauss_id[perm]

    # tile t's run starts at the first row with st >= t; query num_tiles
    # lands at the live row count
    queries = torch.arange(num_tiles + 1, dtype=i32, device=dev)
    tile_start = torch.searchsorted(st, queries, side="left").to(i32)
    tile_start = torch.clamp(tile_start, max=S)
    counts_all = tile_start[1:] - tile_start[:-1]
    clamped = torch.clamp(counts_all, max=tile_capacity)

    if tile_capacity >= instance_capacity:
        keep = st < num_tiles
    else:
        prev_t = torch.cat([torch.full((1,), -1, dtype=i32, device=dev), st[:-1]])
        boundary = (st != prev_t) & (st < num_tiles)
        running_start = torch.cummax(torch.where(boundary, s, 0), dim=0).values
        rank = s - running_start
        keep = (st < num_tiles) & (rank < tile_capacity)
    inst_gauss = torch.where(keep, sg, -1)

    instance_overflow = torch.clamp(total - instance_capacity, min=0)
    tile_overflow = torch.clamp(counts_all - tile_capacity, min=0).sum(dtype=i32)
    return InstanceBinning(
        inst_gauss=inst_gauss,
        tile_count=clamped,
        tile_start=tile_start[:-1],
        num_instances=total,
        overflow=instance_overflow + tile_overflow,
        overflow_instance=instance_overflow,
        overflow_tile=tile_overflow,
    )
