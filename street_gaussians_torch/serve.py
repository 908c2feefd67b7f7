"""Serving: render views of a frozen scene in eval mode.

The port's counterpart of the JAX package's serving render
(`runner.render_sets`, and `bench.py`'s `render_serve`): the sky window
table is built once, then each view goes through
`models.renderer.render_frame`.

    python -m street_gaussians_torch.serve [--views 8] [--device cuda]
        [--profile TRACE.json]

renders the bench scene (1600x1064, 220k background points grown x3,
4 actors, a 1024 sky cubemap drawn from --seed) and prints one JSON
line per view and a summary. --profile traces the views with
torch.profiler, writes the Chrome trace there and adds the device's busy
time, idle share, a per-stage breakdown and the costliest kernels to
the summary.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import time
from typing import Dict, List, Optional, Sequence

import torch

from street_gaussians_torch._device import resolve_device
from street_gaussians_torch.data.synthetic import SyntheticScene, make_synthetic_scene
from street_gaussians_torch.models.renderer import (
    FrameInput,
    RenderOptions,
    SceneParams,
    render_frame,
)
from street_gaussians_torch.models.sky_cubemap import SkyParams, build_sky_table

# bench.py's serving scene and options
BENCH_SCENE = dict(
    num_bkgd=220_000, num_actors=4, H=1064, W=1600,
    background_growth=3.0, actor_growth=3.0,
)
SKY_RESOLUTION = 1024
INSTANCE_CAPACITY = 1536 * 1024
SERVE_OPTS = RenderOptions(
    mode="eval",
    instance_capacity=INSTANCE_CAPACITY,
    tile_capacity=INSTANCE_CAPACITY,
    sky_downsample=2,
)
SERVE_STEP = 10**9  # past the SH ramp: full degree 3


def random_sky(resolution: int, seed: int, device) -> SkyParams:
    """A sky cubemap with texels uniform in [0, 1), drawn on the CPU from
    `seed` so that every device gets the same one."""
    g = torch.Generator().manual_seed(seed)
    cm = torch.rand((3, 6 * resolution * resolution), generator=g)
    return SkyParams(cubemap=cm.to(device))


def bench_scene(seed: int = 0, device=None, sky_resolution: int = SKY_RESOLUTION, **overrides):
    """(scene, params) of bench.py's serving scene; `overrides` replace
    entries of BENCH_SCENE (tests shrink it)."""
    device = resolve_device(device)
    scene = make_synthetic_scene(seed=seed, device=device, **{**BENCH_SCENE, **overrides})
    params = SceneParams(
        gaussians=scene.params_init,
        actor_pose=scene.pose_params_init,
        sky=random_sky(sky_resolution, seed, device),
        color_correction=None,
        pose_correction=None,
    )
    return scene, params


def render_views(
    scene: SyntheticScene,
    params: SceneParams,
    frames: Sequence[FrameInput],
    opts: RenderOptions = SERVE_OPTS,
    device=None,
    sky_table: Optional[torch.Tensor] = None,
    step: int = SERVE_STEP,
) -> List[Dict[str, torch.Tensor]]:
    """Render `frames` in eval mode on `device` (default: the CUDA card;
    raises without one). The scene and frames must live on that device.
    The sky table is built once unless given."""
    device = resolve_device(device)
    # full float32 products, as the JAX code's precision="highest"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if params.gaussians.xyz.device != device:
        raise ValueError(
            f"scene is on {params.gaussians.xyz.device}, render device is {device}"
        )
    if opts.mode == "train":
        raise ValueError("render_views serves: use an eval-mode RenderOptions")
    with torch.no_grad():
        if params.sky is not None and sky_table is None:
            sky_table = build_sky_table(params.sky.cubemap)
        return [
            render_frame(
                params, scene.aux, scene.table, scene.pose_data, f, step,
                opts=opts, sky_table=sky_table,
            )
            for f in frames
        ]


# the profiler ranges of models/renderer.py and ops/rasterize.py
STAGES = ("screen_space", "binning", "payload", "tile_blend", "sky")


def trace_summary(trace_path: str, wall_ms: float, views: int) -> dict:
    """From a Chrome trace of `views` views that took `wall_ms` on the
    host: the device's busy time (union of kernel, copy and set
    intervals) and idle share, and per view and stage the device span,
    the kernel time and count inside it, the host time and the host's
    stream synchronisations; plus the kernels that took the most time."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    dev = sorted(
        (e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset") and "dur" in e),
        key=lambda e: e["ts"],
    )
    busy_us, end = 0.0, float("-inf")
    for e in dev:
        a, b = e["ts"], e["ts"] + e["dur"]
        if b > end:
            busy_us += b - max(a, end)
            end = b
    syncs = [e for e in events if e.get("cat") == "cuda_runtime"
             and e.get("name") in ("cudaStreamSynchronize", "cudaDeviceSynchronize")]
    stages = {k: dict(span_ms=0.0, kernel_ms=0.0, kernels=0, host_ms=0.0, host_syncs=0) for k in STAGES}
    for e in events:
        st = stages.get(e.get("name"))
        if st is None or "dur" not in e:
            continue
        lo, hi = e["ts"], e["ts"] + e["dur"]
        if e.get("cat") == "gpu_user_annotation":
            st["span_ms"] += e["dur"] / 1e3
            inside = [k for k in dev if k.get("cat") == "kernel" and lo <= k["ts"] <= hi]
            st["kernel_ms"] += sum(k["dur"] for k in inside) / 1e3
            st["kernels"] += len(inside)
        elif e.get("cat") == "user_annotation":
            st["host_ms"] += e["dur"] / 1e3
            st["host_syncs"] += sum(lo <= y["ts"] <= hi for y in syncs)
    for st in stages.values():
        for k in st:
            st[k] /= views
    by_name: Dict[str, list] = {}
    for e in dev:
        t = by_name.setdefault(e["name"][:80], [0.0, 0])
        t[0] += e["dur"] / 1e3 / views
        t[1] += 1 / views
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    return {
        "device_busy_ms": busy_us / 1e3, "wall_ms": wall_ms,
        "idle_share": (1.0 - busy_us / 1e3 / wall_ms) if dev else None,
        "per_view": stages,
        "top_kernels_per_view": [{"name": n, "ms": t, "launches": c} for n, (t, c) in top],
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--views", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    ap.add_argument("--profile", metavar="TRACE", default=None,
                    help="trace the timed views and write a Chrome trace here")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    scene, params = bench_scene(args.seed, device)
    frames = [scene.frames[i % len(scene.frames)] for i in range(args.views)]
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    with torch.no_grad():
        sky_table = build_sky_table(params.sky.cubemap)
    render_views(scene, params, frames[:1], device=device, sky_table=sky_table)  # warm-up
    sync()
    times = []
    prof = contextlib.nullcontext()
    if args.profile:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
    outs = []
    with prof:
        for f in frames:
            t0 = time.perf_counter()
            outs += render_views(scene, params, [f], device=device, sky_table=sky_table)
            sync()
            times.append((time.perf_counter() - t0) * 1e3)
    for i, out in enumerate(outs):
        print(json.dumps({
            "view": i, "ms": times[i],
            "num_instances": int(out["num_instances"]), "overflow": int(out["overflow"]),
            "rgb_finite": bool(torch.isfinite(out["rgb"]).all()),
        }))
    summary = {
        "device": str(device), "name": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "views": len(frames), "mean_ms": sum(times) / len(times),
        "capacity": scene.table.capacity, "opts": dataclasses.asdict(SERVE_OPTS),
    }
    if args.profile:
        prof.export_chrome_trace(args.profile)
        summary["profile"] = trace_summary(args.profile, sum(times), len(frames))
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
