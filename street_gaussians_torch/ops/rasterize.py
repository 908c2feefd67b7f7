"""Rasterization: preprocess output -> binning -> payload gather ->
tile blend -> image assembly + background compositing.

Port of street_gaussians_tpu/ops/rasterize.py, both layouts: the
instance-major payload (ops/tile_raster2.py, the main path) and the
dense per-tile table (ops/tile_raster.py, an independent second layout
that checks the first). The payload gather and the tile blend are
autograd Functions with scatter-free gradients: the blend's is its
backward kernel, the gather's a stable sort of the cotangent rows by
Gaussian id and a segmented row-sum (ops/segsum.py). The JAX package
leaves the table gather's gradient to XLA's scatter-add; here it takes
the same sort and row-sum as the instance layout's.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional, Union

import torch
from torch.profiler import record_function

from street_gaussians_torch.ops import binning as binning_lib
from street_gaussians_torch.ops.preprocess import TILE, GaussianScreenData
from street_gaussians_torch.ops.segsum import BIG, segment_rowsum
from street_gaussians_torch.ops.tile_raster import TileBlend
from street_gaussians_torch.ops.tile_raster2 import (
    CHUNK,
    TileBlendInstances,
    payload_rows,
)


@dataclasses.dataclass(frozen=True)
class RasterizeConfig:
    """Static capacities for the fixed-shape pipeline."""

    tile_capacity: int = 1024  # max gaussians blended per tile
    instance_capacity: int = 2**20  # max (gaussian, tile) instances
    # "instance": packed instance-major payload (tile_raster2);
    # "table": dense [num_tiles, tile_capacity] payload (tile_raster),
    # tile_capacity a multiple of 128
    layout: str = "instance"
    # instance layout only: drop (gaussian, tile) instances whose max
    # possible alpha in the tile is provably < 1/255
    # (binning.bin_gaussians_instances)
    corner_cull: bool = True


def _grid_dims(H: int, W: int):
    return (W + TILE - 1) // TILE, (H + TILE - 1) // TILE


def _gather_blocks(src: torch.Tensor, inst_gauss: torch.Tensor) -> torch.Tensor:
    valid = inst_gauss >= 0
    safe = torch.clamp(inst_gauss, min=0).to(torch.int64)
    gathered = torch.where(valid[:, None], src[safe], 0.0)
    S = gathered.shape[0]
    nb = -(-S // CHUNK)
    c_pad = src.shape[1]
    # dead rows pad the capacity to a block multiple, plus the trash block
    payload = torch.zeros((nb + 1, CHUNK, c_pad), dtype=src.dtype, device=src.device)
    payload.view(-1, c_pad)[:S] = gathered
    return payload.transpose(1, 2).contiguous()


def payload_grad(d_blocks: torch.Tensor, inst_gauss: torch.Tensor, n: int) -> torch.Tensor:
    """The gather's gradient, [n, C], without a scatter (the JAX
    package's _bpb_bwd): sort the slot rows by Gaussian id (stable, so
    the sum order is fixed), carry the C channels along, and sum each
    id's contiguous rows with segment_rowsum. Dropped slots get key BIG
    and fall in no segment."""
    C = d_blocks.shape[1]
    S = inst_gauss.shape[0]
    flat = d_blocks.transpose(0, 1).reshape(C, -1)[:, :S]  # [C, S]
    keys = torch.where(inst_gauss >= 0, inst_gauss, BIG).to(torch.int32)
    skeys, order = torch.sort(keys, stable=True)
    return segment_rowsum(flat[:, order], skeys, num_segments=n).t()


class BuildPayloadBlocks(torch.autograd.Function):
    @staticmethod
    def forward(ctx, src, inst_gauss):
        ctx.save_for_backward(inst_gauss)
        ctx.n = src.shape[0]
        return _gather_blocks(src, inst_gauss)

    @staticmethod
    def backward(ctx, d_blocks):
        (inst_gauss,) = ctx.saved_tensors
        return payload_grad(d_blocks, inst_gauss, ctx.n), None


def build_payload_blocks(src: torch.Tensor, inst_gauss: torch.Tensor) -> torch.Tensor:
    """Gather [N, C] rows into packed instance blocks
    [num_blocks + 1, C, 128] (the final block is the trash block; dropped
    slots are zero), with the scatter-free gradient `payload_grad`."""
    return BuildPayloadBlocks.apply(src, inst_gauss)


class BuildPayloadTable(torch.autograd.Function):
    @staticmethod
    def forward(ctx, src, tile_gauss):
        ctx.save_for_backward(tile_gauss)
        ctx.n = src.shape[0]
        rows = src[torch.clamp(tile_gauss, min=0).to(torch.int64)]  # [T, K, C]
        return torch.where((tile_gauss >= 0)[:, :, None], rows, 0.0).transpose(1, 2).contiguous()

    @staticmethod
    def backward(ctx, d_table):
        (tile_gauss,) = ctx.saved_tensors
        return payload_grad(d_table, tile_gauss.reshape(-1), ctx.n), None


def build_payload_table(src: torch.Tensor, tile_gauss: torch.Tensor) -> torch.Tensor:
    """Gather [N, C] rows into the dense table [num_tiles, C, K] (empty
    slots zero, so their opacity is 0), with the scatter-free gradient
    `payload_grad` over the table's T * K slots."""
    return BuildPayloadTable.apply(src, tile_gauss)


class BlendInputs(NamedTuple):
    payload: torch.Tensor  # [NB + 1, c_pad, 128], or [num_tiles, c_pad, K] for the table
    bins: Union[binning_lib.InstanceBinning, binning_lib.TileBinning]
    num_features: int
    grid_x: int
    grid_y: int


def blend_inputs(
    screen: GaussianScreenData,
    H: int,
    W: int,
    extra_features: Optional[torch.Tensor] = None,
    config: RasterizeConfig = RasterizeConfig(),
    absgrad_dummy: Optional[torch.Tensor] = None,
) -> BlendInputs:
    """Binning and the payload: everything the tile blend reads.
    absgrad_dummy: optional [N, 2] zeros in the payload's AbsGS rows
    (see `rasterize`)."""
    if config.layout not in ("instance", "table"):
        raise ValueError(f"layout must be 'instance' or 'table', got {config.layout!r}")
    table = config.layout == "table"
    grid_x, grid_y = _grid_dims(H, W)
    feats = [screen.rgb, screen.depth[:, None]]
    if extra_features is not None:
        feats.append(extra_features)
    features = torch.cat(feats, dim=-1)  # [N, F]
    F = features.shape[-1]
    c_pad = payload_rows(F)
    with record_function("binning"):
        if table:
            bins = binning_lib.bin_gaussians(
                screen, grid_x, grid_y, config.instance_capacity, config.tile_capacity
            )
        else:
            bins = binning_lib.bin_gaussians_instances(
                screen, grid_x, grid_y, config.instance_capacity, config.tile_capacity,
                corner_cull=config.corner_cull,
            )
    with record_function("payload"):
        # one [N, c_pad] source: (mx, my, ca, cb, cc, op, feats..., AbsGS
        # rows, zero rows)
        cols = [screen.mean2d, screen.conic, screen.opacity[:, None], features]
        if absgrad_dummy is not None:
            cols.append(absgrad_dummy)
        src = torch.cat(cols, dim=-1)
        src = torch.nn.functional.pad(src, (0, c_pad - src.shape[1]))
        if table:
            payload = build_payload_table(src, bins.tile_gauss)
        else:
            payload = build_payload_blocks(src, bins.inst_gauss)
    return BlendInputs(payload, bins, F, grid_x, grid_y)


def rasterize(
    screen: GaussianScreenData,
    H: int,
    W: int,
    bg_color: torch.Tensor,
    extra_features: Optional[torch.Tensor] = None,
    config: RasterizeConfig = RasterizeConfig(),
    absgrad_dummy: Optional[torch.Tensor] = None,
) -> Dict[str, torch.Tensor]:
    """Rasterize preprocessed Gaussians to an image.

    absgrad_dummy: optional [N, 2] zeros. It does not change the output;
    its gradient is the per-pixel-abs sum of the mean2d gradient (AbsGS
    densification), which the blend's backward writes into its rows.

    Returns rgb [H,W,3] (composited over bg_color as rgb + T * bg), acc
    [H,W], depth [H,W], T [H,W], extra [H,W,S] (if requested), and the
    binning diagnostics."""
    bi = blend_inputs(screen, H, W, extra_features, config, absgrad_dummy)
    F, grid_x, grid_y = bi.num_features, bi.grid_x, bi.grid_y
    with record_function("tile_blend"):
        if config.layout == "table":
            out = TileBlend.apply(bi.payload, bi.bins.tile_count, F, grid_x)
        else:
            out = TileBlendInstances.apply(
                bi.payload, bi.bins.tile_start, bi.bins.tile_count, F, grid_x, grid_x * grid_y
            )
    # tile-major [T, 256, F+1] -> [H, W, F+1]
    img = (
        out.reshape(grid_y, grid_x, TILE, TILE, F + 1)
        .permute(0, 2, 1, 3, 4)
        .reshape(grid_y * TILE, grid_x * TILE, F + 1)[:H, :W]
    )
    accum = img[..., :F]
    T = img[..., F]
    result = {
        "rgb": accum[..., 0:3] + T[..., None] * bg_color[None, None, :],
        "depth": accum[..., 3],
        "acc": 1.0 - T,
        "T": T,
        "num_instances": bi.bins.num_instances,
        "overflow": bi.bins.overflow,
        "overflow_instance": bi.bins.overflow_instance,
        "overflow_tile": bi.bins.overflow_tile,
    }
    if extra_features is not None:
        result["extra"] = accum[..., 4:]
    return result


def render_reference(
    screen: GaussianScreenData,
    H: int,
    W: int,
    bg_color: torch.Tensor,
    extra_features: Optional[torch.Tensor] = None,
) -> Dict[str, torch.Tensor]:
    """Same contract as `rasterize` (rgb, depth, acc, T and, with
    extra_features, extra), through the slow exact per-pixel oracle
    (ops/reference_rasterizer.py); no binning, so no counters."""
    from street_gaussians_torch.ops.reference_rasterizer import reference_render

    feats = [screen.rgb, screen.depth[:, None]]
    if extra_features is not None:
        feats.append(extra_features)
    out = reference_render(screen, torch.cat(feats, dim=-1), H, W)
    accum, T = out.features, out.transmittance
    result = {
        "rgb": accum[..., 0:3] + T[..., None] * bg_color[None, None, :],
        "depth": accum[..., 3],
        "acc": 1.0 - T,
        "T": T,
    }
    if extra_features is not None:
        result["extra"] = accum[..., 4:]
    return result
