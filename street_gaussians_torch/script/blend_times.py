"""Times of the four blend kernels at given feature counts, on the card.

    python -m street_gaussians_torch.script.blend_times [--features 4 27] [--reps 20] [--seed 0]
        [--bench-table]

For each F: kernels 2.1 (tile_blend_instances) and 2.2 (tile_blend_bwd,
with the forward's saved state, random cotangents on every channel) on
the bench serving frame (serve.bench_scene, frame 0, eval mode) with
F - 4 extra feature columns uniform in [0, 1) from the seed (the
semantic and normal channels' place), and kernels 2.5 and 2.6
(tile_raster.tile_blend and its backward) on chip_smoke's random table
case (1200 tiles, K = 768) at F. With --bench-table, kernels 2.5 and
2.6 instead on the bench frame's dense table (chip_smoke.py step 7b: K
the largest tile's count rounded up to 128, the same extra columns), the
backward without the forward's state. One JSON line per F with the mean
ms by CUDA events after a warm-up, then the card's name and power limit.
It calls the kernels' public wrappers only, so the same file times an
older checkout of the package as well (run it from that checkout's
root).
"""

from __future__ import annotations

import argparse
import json
import subprocess

import torch

from street_gaussians_torch import serve
from street_gaussians_torch._device import resolve_device, time_ms
from street_gaussians_torch.models.renderer import screen_space
from street_gaussians_torch.ops import rasterize, tile_raster, tile_raster2


def frame_inputs(device, features: int = 4, seed: int = 0):
    """(tile_blend_instances' args, tile_blend_bwd's args) on the bench
    frame with `features` blend features: rgb, depth and features - 4
    extra columns uniform in [0, 1) from `seed`; the backward's cotangents
    are standard normal from `seed`, its `out` the forward's."""
    scene, params = serve.bench_scene(seed=seed, device=device)
    opts = serve.SERVE_OPTS
    frame = scene.frames[0]
    with torch.no_grad():
        screen, _ = screen_space(params, scene.aux, scene.table, scene.pose_data, frame, serve.SERVE_STEP, opts=opts)
        extra = None
        if features > 4:
            gen = torch.Generator().manual_seed(seed)
            extra = torch.rand((screen.depth.shape[0], features - 4), generator=gen).to(device)
        cfg = rasterize.RasterizeConfig(opts.tile_capacity, opts.instance_capacity, corner_cull=opts.corner_cull)
        bi = rasterize.blend_inputs(screen, frame.cam.H, frame.cam.W, extra, config=cfg)
        T = bi.grid_x * bi.grid_y
        fwd = (bi.payload, bi.bins.tile_start, bi.bins.tile_count, bi.num_features, bi.grid_x, T)
        out = tile_raster2.tile_blend_instances(*fwd)
        gout = torch.randn(out.shape, generator=torch.Generator().manual_seed(seed)).to(device)
    return fwd, (*fwd[:3], out, gout, *fwd[3:])


TABLE_ICAP = 2**21  # chip_smoke.py step 7b's instance capacity for the table


def bench_table_inputs(device, features: int = 4, seed: int = 0):
    """(tile_raster.tile_blend's args, tile_blend_bwd's args) on the bench
    frame's dense table (chip_smoke.py step 7b): K the largest tile's
    count rounded up to 128, features - 4 extra columns as frame_inputs,
    cotangents standard normal from `seed`."""
    from street_gaussians_torch.script import parity_check

    scene, params = serve.bench_scene(seed=seed, device=device)
    frame = scene.frames[0]
    H, W = frame.cam.H, frame.cam.W
    with torch.no_grad():
        screen, _ = screen_space(params, scene.aux, scene.table, scene.pose_data, frame, serve.SERVE_STEP,
                                 opts=serve.SERVE_OPTS)
        max_count = parity_check.largest_tile_count(screen, H, W, TABLE_ICAP)
        K = max(1024, -(-max_count // 128) * 128)
        extra = None
        if features > 4:
            gen = torch.Generator().manual_seed(seed)
            extra = torch.rand((screen.depth.shape[0], features - 4), generator=gen).to(device)
        bi = rasterize.blend_inputs(screen, H, W, extra,
                                    config=rasterize.RasterizeConfig(K, TABLE_ICAP, layout="table"))
        fwd = (bi.payload, bi.bins.tile_count, bi.num_features, bi.grid_x)
        out = tile_raster.tile_blend(*fwd)
        gout = torch.randn(out.shape, generator=torch.Generator().manual_seed(seed)).to(device)
    return fwd, (fwd[0], fwd[1], out, gout, *fwd[2:])


def bench_table_times(device, features: int, reps: int = 20, seed: int = 0) -> dict:
    """ms of kernels 2.5 and 2.6 on the bench frame's dense table."""
    fwd, bwd = bench_table_inputs(device, features, seed)
    with torch.no_grad():
        return {
            "features": features, "bench_table_K": fwd[0].shape[2],
            "tile_blend_table_ms": time_ms(lambda: tile_raster.tile_blend(*fwd), reps, device),
            "tile_blend_table_bwd_ms": time_ms(lambda: tile_raster.tile_blend_bwd(*bwd), max(reps // 4, 1), device),
        }


def kernel_times(device, features: int, reps: int = 20, seed: int = 0) -> dict:
    """ms of kernels 2.1, 2.2, 2.5 and 2.6 at `features` (see the module
    docstring)."""
    from chip_smoke import random_table_case

    fwd, bwd = frame_inputs(device, features, seed)
    with torch.no_grad():
        _, state = tile_raster2._forward(*fwd)
        table = random_table_case(5, device, F=features)
        tout = tile_raster.tile_blend(*table)
        tgout = torch.randn(tout.shape, generator=torch.Generator().manual_seed(seed)).to(device)
        tbwd = (table[0], table[1], tout, tgout, features, table[3])
        res = {
            "features": features,
            "tile_blend_instances_ms": time_ms(lambda: tile_raster2.tile_blend_instances(*fwd), reps, device),
            "tile_blend_bwd_ms": time_ms(lambda: tile_raster2.tile_blend_bwd(*bwd, state=state), reps, device),
            "tile_blend_table_ms": time_ms(lambda: tile_raster.tile_blend(*table), reps, device),
            "tile_blend_table_bwd_ms": time_ms(lambda: tile_raster.tile_blend_bwd(*tbwd), max(reps // 2, 1), device),
        }
    return res


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--features", type=int, nargs="+", default=[4, 27])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--bench-table", action="store_true",
                    help="kernels 2.5 and 2.6 on the bench frame's dense table instead")
    args = ap.parse_args(argv)
    device = resolve_device(None)
    times = bench_table_times if args.bench_table else kernel_times
    for f in args.features:
        print(json.dumps(times(device, f, args.reps, args.seed)), flush=True)
        torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(json.dumps({"device": torch.cuda.get_device_name(device), "name_and_power_limit": smi}))


if __name__ == "__main__":
    main()
