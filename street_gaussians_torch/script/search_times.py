"""Where the segmented row-sum and the run expansion spend their time:
their searches against the whole kernel, and the kernel's share of the
two gradient steps (VJPs) around the row-sum.

    python -m street_gaussians_torch.script.search_times [--iters 20]
        [--variant='-DSG_SEG_ITEMS=4' ...]

builds `csrc/segsum.cu` and `csrc/fill.cu` a second time with
-DSG_SEARCH_ONLY (each kernel stops once it has found where its work
lies, and keeps the searches by one write; the shipped libraries carry
no such stop) and, on the bench inputs, prints one JSON line each:

  search   per call: the payload and the sky call of segment_rowsum (a
           bench train step's own inputs) and expand_runs (the bench
           frame's): whole kernel ms and search-only ms, CUDA events
  vjp      per gradient step around segment_rowsum, ms of each stage:
           payload (rasterize.payload_grad): the channel-major copy of
           the gradient blocks, the stable sort of the keys, the row
           gather by the sort's order, the kernel, the whole step; sky
           (sky_cubemap.bilinear_taps_grad): the 12 tap channels, the
           sort, the gather, the kernel, the three tap-plane shifts,
           the whole step
  sweep    with --variant: both kernels timed in builds with other nvcc
           flags (a variant is one string of flags, '' the shipped
           build; the sources' tuning macros are SG_SEG_ITEMS and
           SG_FILL_ITEMS, items per thread)
"""

from __future__ import annotations

import argparse
import json
import subprocess

import torch

from street_gaussians_torch import serve, train
from street_gaussians_torch._device import resolve_device, time_ms
from street_gaussians_torch.models import sky_cubemap
from street_gaussians_torch.models.renderer import screen_space
from street_gaussians_torch.ops import binning, fill, rasterize, segsum

PROBE_FLAGS = ("-DSG_SEARCH_ONLY",)
SOURCES = ("segsum", "fill")


def bench_inputs(device, seed: int = 0, **overrides) -> dict:
    """The bench frame's expand_runs arguments and a bench train step's
    arguments of both gradient steps around segment_rowsum. `overrides`
    (sky_resolution and entries of serve.BENCH_SCENE) shrink the scene
    for a run on the CPU."""
    scene, params = serve.bench_scene(seed=seed, device=device, **overrides)
    opts = serve.SERVE_OPTS
    frame = scene.frames[0]
    with torch.no_grad():
        screen, _ = screen_space(params, scene.aux, scene.table, scene.pose_data, frame,
                                 serve.SERVE_STEP, opts=opts)
        gx, gy = (frame.cam.W + 15) // 16, (frame.cam.H + 15) // 16
        ex = binning.expand_inputs(screen, gx, gy, corner_cull=opts.corner_cull)
    expand = (ex.vals, ex.offs, ex.total, opts.instance_capacity)
    del scene, params, screen
    cell = train.bench_train_cell(device, seed=seed, **overrides)
    calls = {}
    real = rasterize.payload_grad, sky_cubemap.bilinear_taps_grad

    def recorder(name, fn):
        def record(*args):
            calls[name] = tuple(a.detach().clone() if torch.is_tensor(a) else a for a in args)
            return fn(*args)
        return record

    rasterize.payload_grad = recorder("payload", real[0])
    sky_cubemap.bilinear_taps_grad = recorder("sky", real[1])
    try:
        train.run_step(cell, cell.state, torch.Generator(device=device).manual_seed(seed))
    finally:
        rasterize.payload_grad, sky_cubemap.bilinear_taps_grad = real
    if device.type == "cuda":
        torch.cuda.synchronize()
    return {"expand": expand, **calls}


def payload_stages(d_blocks, inst_gauss, n):
    """payload_grad's stages as thunks, each on the previous one's
    output (computed once here)."""
    C, S = d_blocks.shape[1], inst_gauss.shape[0]
    flat_fn = lambda: d_blocks.transpose(0, 1).reshape(C, -1)[:, :S]  # noqa: E731
    sort_fn = lambda: torch.sort(  # noqa: E731
        torch.where(inst_gauss >= 0, inst_gauss, segsum.BIG).to(torch.int32), stable=True)
    flat = flat_fn()
    skeys, order = sort_fn()
    rows = flat[:, order]
    return {
        "channel_major_copy": flat_fn, "sort": sort_fn, "gather": lambda: flat[:, order],
        "kernel": lambda: segsum.segment_rowsum(rows, skeys, num_segments=n),
        "whole": lambda: rasterize.payload_grad(d_blocks, inst_gauss, n),
    }, (rows, skeys, n)


def sky_stages(d_out, base, e4, T, R):
    """bilinear_taps_grad's stages as thunks (see payload_stages)."""
    C = d_out.shape[-1]
    ef = e4.reshape(-1, 4)
    chans_fn = lambda: (ef[:, :, None] * d_out.reshape(-1, C)[:, None, :]).reshape(-1, 4 * C).t()  # noqa: E731
    sort_fn = lambda: torch.sort(base.reshape(-1).to(torch.int32), stable=True)  # noqa: E731
    chans = chans_fn()
    skeys, order = sort_fn()
    rows = chans[:, order]
    planes = segsum.segment_rowsum(rows, skeys, num_segments=T)

    def shifts():
        d_cm = planes[0:C].clone()
        for t, off in enumerate((1, R, R + 1)):
            d_cm[:, off:] += planes[(t + 1) * C: (t + 2) * C, : T - off]
        return d_cm

    return {
        "tap_channels": chans_fn, "sort": sort_fn, "gather": lambda: chans[:, order],
        "kernel": lambda: segsum.segment_rowsum(rows, skeys, num_segments=T),
        "shifts": shifts, "whole": lambda: sky_cubemap.bilinear_taps_grad(d_out, base, e4, T, R),
    }, (rows, skeys, T)


def with_build_flags(flags, fn):
    """fn() with segsum.cu and fill.cu built with these nvcc flags."""
    saved = segsum.BUILD_FLAGS, fill.BUILD_FLAGS
    segsum.BUILD_FLAGS = fill.BUILD_FLAGS = tuple(flags)
    try:
        return fn()
    finally:
        segsum.BUILD_FLAGS, fill.BUILD_FLAGS = saved


def kernel_calls(inputs) -> dict:
    """{call: thunk} of the three bench calls of the two kernels."""
    _, (prow, pkeys, pn) = payload_stages(*inputs["payload"])
    _, (srow, skeys, sn) = sky_stages(*inputs["sky"])
    return {
        "segment_rowsum payload": lambda: segsum.segment_rowsum(prow, pkeys, num_segments=pn),
        "segment_rowsum sky": lambda: segsum.segment_rowsum(srow, skeys, num_segments=sn),
        "expand_runs": lambda: fill.expand_runs(*inputs["expand"]),
    }


def search_rows(inputs, iters: int) -> list:
    dev = inputs["expand"][0].device
    rows = []
    with torch.no_grad():
        for call, fn in kernel_calls(inputs).items():
            whole = time_ms(fn, iters, dev)
            search = with_build_flags(PROBE_FLAGS, lambda: time_ms(fn, iters, dev))
            rows.append({"search": call, "whole_ms": whole, "search_only_ms": search,
                         "search_share": search / whole})
    return rows


def vjp_rows(inputs, iters: int) -> list:
    dev = inputs["expand"][0].device
    rows = []
    with torch.no_grad():
        for what, (stages, _) in (("payload", payload_stages(*inputs["payload"])),
                                  ("sky", sky_stages(*inputs["sky"]))):
            ms = {k: time_ms(fn, iters, dev) for k, fn in stages.items()}
            rows.append({"vjp": what, **{f"{k}_ms": v for k, v in ms.items()},
                         "kernel_share": ms["kernel"] / ms["whole"]})
    return rows


def sweep(inputs, variants, iters: int) -> list:
    """Per build variant: each call's ms, and its largest difference
    from the shipped build's output (another tiling sums in another
    order)."""
    dev = inputs["expand"][0].device
    rows = []
    with torch.no_grad():
        calls = kernel_calls(inputs)
        shipped = {call: fn() for call, fn in calls.items()}
        for flags in variants:
            def run():
                row = {}
                for call, fn in calls.items():
                    row[f"{call}_ms"] = time_ms(fn, iters, dev)
                    row[f"{call}_max_diff"] = float((fn() - shipped[call]).abs().max())
                return row
            rows.append({"sweep": True, "variant": flags, **with_build_flags(flags.split(), run)})
    return rows


def main(argv=None) -> None:
    from street_gaussians_torch.kernels import _build

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--variant", action="append", default=[],
                    help="nvcc flags of a build to time, as --variant='-DSG_SEG_ITEMS=4'; may repeat")
    args = ap.parse_args(argv)
    device = resolve_device(None)
    builds = [_build.build(SOURCES), _build.build(SOURCES, PROBE_FLAGS)]
    builds += [_build.build(SOURCES, v.split()) for v in args.variant]
    for b in builds:
        for name, info in b.items():
            for ln in info["log"].splitlines():
                if "registers" in ln:
                    print(f"[build] {name}: {ln.strip()}")
    inputs = bench_inputs(device, args.seed)
    for row in search_rows(inputs, args.iters) + vjp_rows(inputs, args.iters):
        print(json.dumps(row))
    for row in sweep(inputs, args.variant, args.iters):
        print(json.dumps(row))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(json.dumps({"device": torch.cuda.get_device_name(device), "name_and_power_limit": smi}))


if __name__ == "__main__":
    main()
