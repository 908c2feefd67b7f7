"""Rasterization: preprocess output -> binning -> payload gather ->
tile blend -> image assembly + background compositing.

Port of street_gaussians_tpu/ops/rasterize.py, forward, on the
instance layout. The dense-table layout ("table") is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional

import torch
from torch.profiler import record_function

from street_gaussians_torch.ops import binning as binning_lib
from street_gaussians_torch.ops.preprocess import TILE, GaussianScreenData
from street_gaussians_torch.ops.tile_raster2 import (
    CHUNK,
    payload_rows,
    tile_blend_instances,
)


@dataclasses.dataclass(frozen=True)
class RasterizeConfig:
    """Static capacities for the fixed-shape pipeline."""

    tile_capacity: int = 1024  # max gaussians blended per tile
    instance_capacity: int = 2**20  # max (gaussian, tile) instances
    layout: str = "instance"  # only the instance-major payload is ported
    # drop (gaussian, tile) instances whose max possible alpha in the
    # tile is provably < 1/255 (binning.bin_gaussians_instances)
    corner_cull: bool = True


def _grid_dims(H: int, W: int):
    return (W + TILE - 1) // TILE, (H + TILE - 1) // TILE


def build_payload_blocks(src: torch.Tensor, inst_gauss: torch.Tensor) -> torch.Tensor:
    """Gather [N, C] rows into packed instance blocks
    [num_blocks + 1, C, 128] (the final block is the trash block; dropped
    slots are zero). Forward only: its gradient, a sorted segmented
    row-sum, comes with the training slice."""
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


class BlendInputs(NamedTuple):
    payload: torch.Tensor  # [NB + 1, c_pad, 128]
    bins: binning_lib.InstanceBinning
    num_features: int
    grid_x: int
    grid_y: int


def blend_inputs(
    screen: GaussianScreenData,
    H: int,
    W: int,
    extra_features: Optional[torch.Tensor] = None,
    config: RasterizeConfig = RasterizeConfig(),
) -> BlendInputs:
    """Binning and the payload: everything the tile blend reads."""
    if config.layout != "instance":
        raise NotImplementedError(f"layout={config.layout!r} is not ported yet")
    grid_x, grid_y = _grid_dims(H, W)
    feats = [screen.rgb, screen.depth[:, None]]
    if extra_features is not None:
        feats.append(extra_features)
    features = torch.cat(feats, dim=-1)  # [N, F]
    F = features.shape[-1]
    c_pad = payload_rows(F)
    with record_function("binning"):
        bins = binning_lib.bin_gaussians_instances(
            screen, grid_x, grid_y, config.instance_capacity, config.tile_capacity,
            corner_cull=config.corner_cull,
        )
    with record_function("payload"):
        # one [N, c_pad] source: (mx, my, ca, cb, cc, op, feats..., zero rows)
        src = torch.cat([screen.mean2d, screen.conic, screen.opacity[:, None], features], dim=-1)
        src = torch.nn.functional.pad(src, (0, c_pad - src.shape[1]))
        payload = build_payload_blocks(src, bins.inst_gauss)
    return BlendInputs(payload, bins, F, grid_x, grid_y)


def rasterize(
    screen: GaussianScreenData,
    H: int,
    W: int,
    bg_color: torch.Tensor,
    extra_features: Optional[torch.Tensor] = None,
    config: RasterizeConfig = RasterizeConfig(),
) -> Dict[str, torch.Tensor]:
    """Rasterize preprocessed Gaussians to an image.

    Returns rgb [H,W,3] (composited over bg_color as rgb + T * bg), acc
    [H,W], depth [H,W], T [H,W], extra [H,W,S] (if requested), and the
    binning diagnostics."""
    bi = blend_inputs(screen, H, W, extra_features, config)
    F, grid_x, grid_y = bi.num_features, bi.grid_x, bi.grid_y
    with record_function("tile_blend"):
        out = tile_blend_instances(
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
