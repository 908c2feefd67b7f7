"""Where the two blend kernels of the main path spend their time: the
run lengths they are given, and each block's start and end on the card.

    python -m street_gaussians_torch.script.block_times [--iters 3]
        [--seg 512 1024 ...] [--variant='-DSG_BWD_LB=8' ...] [--features 27]

builds `csrc/tile_blend.cu` and `csrc/tile_blend_bwd.cu` a second time
with -DSG_BLOCK_TIMES (see `csrc/block_times.cuh`; the shipped libraries
carry no timer), and on the bench frame (serve.bench_scene, frame 0) and
on a bench train step's own backward inputs (train.bench_train_cell)
prints, one JSON line each:

  runs     the tiles' run lengths: median, mean, 99th percentile,
           maximum, tiles of 1,024 instances and more and their share
  blocks   per kernel launch inside the forward and the backward:
           blocks that ran, the launch's span (first start to last end),
           its longest block (the critical path), the sum of block times
           over the blocks the card holds at once (the throughput time:
           what the launch would take if its work spread evenly), and
           when half and 99% of the blocks had ended
  features with --features F > 4: the same on the bench frame with F - 4
           extra feature columns (script.blend_times.frame_inputs), the
           backward on that frame with random cotangents instead of a
           train step's; F above 8 takes the kernels' runtime-count
           variants, whose blocks per SM the probe build reports too
  sweep    with --seg and/or --variant: the forward and the backward
           (with the forward's saved state, and without) timed by CUDA
           events at other segment lengths (lanes; a length beyond every
           run means no run is split) and in builds with other nvcc
           flags (a variant is one string of flags, '' the shipped
           build: the sources' tuning macros are SG_FWD_MIN_BLOCKS,
           SG_BWD_LB and SG_BWD_MIN_BLOCKS)
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess

import numpy as np
import torch

from street_gaussians_torch import serve, train
from street_gaussians_torch._device import resolve_device, time_ms
from street_gaussians_torch.kernels import _build
from street_gaussians_torch.models.renderer import screen_space
from street_gaussians_torch.ops import rasterize, tile_raster2

PROBE_FLAGS = ("-DSG_BLOCK_TIMES",)
REGION_STRIDE = 1 << 16  # block slots per kernel launch (csrc/block_times.cuh)
# the launches inside one call of each wrapper, in the order of their regions
REGIONS = {
    "tile_blend": ("plan", "block log-sums (long tiles)", "blend", "combine (long tiles)"),
    "tile_blend_bwd": ("backward",),
}


def run_length_stats(tile_count: torch.Tensor) -> dict:
    c = tile_count.detach().cpu().numpy().astype(np.int64)
    long = c >= 1024
    return {
        "tiles": int(c.size), "instances": int(c.sum()), "median": float(np.median(c)),
        "mean": float(c.mean()), "p99": float(np.percentile(c, 99)), "max": int(c.max()),
        "tiles_ge_1024": int(long.sum()), "share_ge_1024": float(c[long].sum() / max(c.sum(), 1)),
        "tiles_ge_8192": int((c >= 8192).sum()), "longest": sorted(c.tolist(), reverse=True)[:12],
    }


def _probe_lib(name: str) -> ctypes.CDLL:
    def bind(lib):
        lib.sg_set_block_times.argtypes = [ctypes.c_void_p]
        lib.sg_set_block_times.restype = ctypes.c_int
        lib.sg_blocks_per_sm.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.sg_blocks_per_sm.restype = ctypes.c_int

    return _build.load(name, bind, PROBE_FLAGS)


def block_times(name: str, fn, num_features: int, iters: int = 3) -> list:
    """Run fn() (a wrapper of `csrc/<name>.cu`) on the probe build and
    return one dict per kernel launch inside it, the run of the `iters`
    with the shortest span."""
    lib = _probe_lib(name)
    dev = torch.device("cuda", torch.cuda.current_device())
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    regions = REGIONS[name]
    buf = torch.zeros((len(regions), REGION_STRIDE, 2), dtype=torch.int64, device=dev)
    best = None
    saved = tile_raster2.BUILD_FLAGS
    tile_raster2.BUILD_FLAGS = PROBE_FLAGS
    try:
        fn()  # warm-up: builds and loads the probe library
        _build.check(lib.sg_set_block_times(_build.ptr(buf)), "sg_set_block_times")
        for _ in range(iters):
            buf.zero_()
            fn()
            torch.cuda.synchronize()
            t = buf.cpu().numpy()
            ran = t[..., 1] > 0
            if best is None or np.ptp(t[ran]) < np.ptp(best[best[..., 1] > 0]):
                best = t
        _build.check(lib.sg_set_block_times(None), "sg_set_block_times")
    finally:
        tile_raster2.BUILD_FLAGS = saved
    ran = best[..., 1] > 0
    t0 = best[..., 0][ran].min()
    out = []
    for r, launch in enumerate(regions):
        if not ran[r].any():
            continue
        s, e = best[r, ran[r], 0], best[r, ran[r], 1]
        per_sm = lib.sg_blocks_per_sm(r, num_features)
        d = (e - s) / 1e6
        out.append({
            "kernel": name, "launch": launch, "blocks": int(ran[r].sum()),
            "start_ms": float((s.min() - t0) / 1e6), "span_ms": float((e.max() - s.min()) / 1e6),
            "longest_block_ms": float(d.max()), "sum_block_ms": float(d.sum()),
            "blocks_per_sm": per_sm, "throughput_ms": float(d.sum() / (sms * per_sm)),
            "end_p50_ms": float((np.percentile(e, 50) - s.min()) / 1e6),
            "end_p99_ms": float((np.percentile(e, 99) - s.min()) / 1e6),
        })
    out.append({"kernel": name, "launch": "all", "span_ms": float((best[..., 1][ran].max() - t0) / 1e6)})
    return out


def sweep(fwd, bwd, segs, variants, iters: int = 20) -> list:
    """Forward (bench frame), and backward (train step) with and without
    the forward's state, in ms by CUDA events, per segment length and
    build variant."""
    dev = fwd[0].device
    saved = tile_raster2.SEG, tile_raster2.BUILD_FLAGS
    rows = []
    try:
        with torch.no_grad():
            for flags in variants or [""]:
                tile_raster2.BUILD_FLAGS = tuple(flags.split())
                for seg in segs or [saved[0]]:
                    tile_raster2.SEG = seg
                    _, state = tile_raster2._forward(*bwd[:3], *bwd[5:])
                    rows.append({
                        "sweep": True, "seg": seg, "variant": flags,
                        "fwd_ms": time_ms(lambda: tile_raster2.tile_blend_instances(*fwd), iters, dev),
                        "bwd_ms": time_ms(lambda: tile_raster2.tile_blend_bwd(*bwd, state=state), iters, dev),
                        "bwd_no_state_ms": time_ms(lambda: tile_raster2.tile_blend_bwd(*bwd), iters, dev),
                    })
    finally:
        tile_raster2.SEG, tile_raster2.BUILD_FLAGS = saved
    return rows


def bench_inputs(device, seed: int = 0):
    """(forward args of the bench frame, backward args of a bench train
    step): the arguments of tile_blend_instances and of tile_blend_bwd."""
    scene, params = serve.bench_scene(seed=seed, device=device)
    opts = serve.SERVE_OPTS
    frame = scene.frames[0]
    with torch.no_grad():
        screen, _ = screen_space(params, scene.aux, scene.table, scene.pose_data, frame,
                                 serve.SERVE_STEP, opts=opts)
        cfg = rasterize.RasterizeConfig(opts.tile_capacity, opts.instance_capacity,
                                        corner_cull=opts.corner_cull)
        bi = rasterize.blend_inputs(screen, frame.cam.H, frame.cam.W, config=cfg)
    fwd = (bi.payload, bi.bins.tile_start, bi.bins.tile_count, bi.num_features, bi.grid_x,
           bi.grid_x * bi.grid_y)
    del scene, params, screen
    cell = train.bench_train_cell(device, seed=seed)
    calls = []
    real = tile_raster2.tile_blend_bwd

    def record(*args, **kwargs):
        calls.append(args)
        return real(*args, **kwargs)

    record.launches = real.launches  # the wrapper counts under its module-level name
    tile_raster2.tile_blend_bwd = record
    try:
        train.run_step(cell, cell.state, torch.Generator(device=device).manual_seed(seed))
    finally:
        tile_raster2.tile_blend_bwd = real
        real.launches = record.launches
    torch.cuda.synchronize()
    (bwd,) = calls
    return fwd, tuple(t.detach() if torch.is_tensor(t) else t for t in bwd)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--seg", type=int, nargs="*", default=[], help="segment lengths to time, in lanes")
    ap.add_argument("--variant", action="append", default=[],
                    help="nvcc flags of a build to time, as --variant='-DSG_BWD_LB=8'; may repeat")
    ap.add_argument("--features", type=int, default=4,
                    help="blend features; above 4 the bench frame with random extra columns")
    args = ap.parse_args(argv)
    device = resolve_device(None)
    for name, info in _build.build(REGIONS, PROBE_FLAGS).items():
        for ln in info["log"].splitlines():
            if "registers" in ln or ("Compiling" in ln and ("ILi4" in ln or "plan" in ln or "wide" in ln)):
                print(f"[build] {name}: {ln.strip()}")
    if args.features > 4:
        from street_gaussians_torch.script.blend_times import frame_inputs

        fwd, bwd = frame_inputs(device, args.features, args.seed)
        step = f"bench frame at F={args.features}, random cotangents"
    else:
        fwd, bwd = bench_inputs(device, args.seed)
        step = "train step"
    F = fwd[3]
    print(json.dumps({"runs": "bench frame 0 (serve)", **run_length_stats(fwd[2])}))
    print(json.dumps({"runs": f"bench {step}", **run_length_stats(bwd[2])}))
    with torch.no_grad():
        for what, name, fn in (
            (f"forward, bench frame, F={F}", "tile_blend", lambda: tile_raster2.tile_blend_instances(*fwd)),
            (f"forward, {step}", "tile_blend", lambda: tile_raster2.tile_blend_instances(*bwd[:3], *bwd[5:])),
            (f"backward, {step}", "tile_blend_bwd", lambda: tile_raster2.tile_blend_bwd(*bwd)),
        ):
            for row in block_times(name, fn, F, args.iters):
                print(json.dumps({"what": what, **row}))
    if args.seg or args.variant:
        for row in sweep(fwd, bwd, args.seg, args.variant):
            print(json.dumps(row))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(json.dumps({"device": torch.cuda.get_device_name(device), "name_and_power_limit": smi}))


if __name__ == "__main__":
    main()
