"""The port's tracing: named host spans, the list of every span the
program opens, a profiler session, and the arithmetic that reads the
Chrome trace such a session writes.

`span(name)` opens a torch.profiler `record_function` range while a
profiler session is active and otherwise returns one shared null
context, so that with no profiler running a span costs one flag check
(a `record_function` costs ~11-13 us an enter and exit even then).
Every range the program opens goes through it, and `SPANS` names them
all. A span opened inside a custom autograd Function's backward runs on
autograd's thread, on the profiler's clock.

The arithmetic (`device_events`, `busy_ms`, `host_syncs`,
`trace_summary`, `trace_stats`, `sync_sites`) reads a trace only, so one
version of it compares traces that two versions of the port wrote
(`python -m street_gaussians_torch.script.trace_stats`).
"""

from __future__ import annotations

import contextlib
import json
from typing import Dict, List, Sequence

import torch

_NULL = contextlib.nullcontext()
_profiler_enabled = torch._C._autograd._profiler_enabled

# the stages of a render (models/renderer.py, ops/rasterize.py)
STAGES = ("screen_space", "binning", "payload", "tile_blend", "sky")
SYNC_PREFIX = "sync/"

# every span the program opens, with what it covers
SPANS = {
    # a render (models/renderer.py, ops/rasterize.py)
    "screen_space": "compose_frame and preprocess_gaussians: the per-Gaussian half of a render",
    "sh": ("preprocess_gaussians' SH colour (ops.sh_color: the Fourier DC, the band mask, the basis along the view "
           "directions and its product with the coefficients)"),
    "binning": "the (Gaussian, tile) instances, their sort and the tiles' runs (ops/binning.py, kernel 2.3)",
    "payload": "the payload rows gathered into instance blocks or the dense table",
    "tile_blend": "the blend forward (kernel 2.1, or 2.5 on the table layout)",
    "sky": "the sky cubemap's lookup and its compositing over the image",
    # a train step (train_lib.py, parallel/tiles.py, parallel/gauss.py)
    "object_render": "the actors rendered alone for the object-opacity loss (past densify_until_iter)",
    "losses": "compute_losses: L1, SSIM, sky BCE, LiDAR depth, object opacity, regularizers",
    "backward": "torch.autograd.grad over the step's loss (the kernels autograd launches from its own thread)",
    "optimizer": "the PSNR, the densify statistics, the learning rates and the row-masked Adam update",
    "densify": "train_lib.densify_cadence: a densify-and-prune round or an opacity reset",
    "grad_allreduce": ("train_lib.apply_gradients over a camera group: the statistics, gradients and scalars "
                       "reduced over its ranks (parallel/comm.py)"),
    # inside the backward, on autograd's thread
    "tile_blend_bwd": "the blend's backward (kernel 2.2, or 2.6 on the table layout)",
    "payload_bwd": "the payload gather's gradient: the stable sort, the column gather and the row-sum (2.4)",
    "sky_bwd": "the sky lookup's gradient: the sort, the row-sum (2.4) and the tap-plane shifts",
    "rows_bwd": "the per-model rows' gradient (rows_from_models: slice sums or a one-hot product)",
    "sh_bwd": "the SH colour's gradient (ops.sh_color's backward kernel on a card)",
    # the parallel modes
    "band_<d>": "tile-row band d of a tile-sharded train step (parallel/tiles.py)",
    "gather_rows": "the screen rows of every rank gathered in a gauss-sharded step (parallel/gauss.py)",
    # runner.training's iteration
    "view": "the iteration's view taken from the shuffled stack (_Plan.view)",
    "ground_truth": "GTCache.get: the view's ground truth, read, resized and uploaded on a miss",
    "viewer": "ViewerBridge.poll: a viewer client's camera served a frame",
    "eval": "evaluate_psnr at a test iteration",
    "log_images": "the debug grid of every 1,000th iteration",
    "save": "the point cloud and the checkpoint at a save iteration",
    # where the host waits on the card, one span a site: a copy from
    # pageable host memory to the card waits on the stream, as does a
    # read back (.item(), .tolist(), a boolean mask's length)
    "sync/lr_scalars": "train_lib.make_lr_tree: the per-row learning rates built from Python floats copied to the card",
    "sync/clip_bounds": ("utils.losses.jnp_maximum / jnp_clip: a bound copied from a Python float (the losses, "
                         "the sky's clamp, the PSNR)"),
    "sync/stat_scale": "optim.densify.step_stats: the (W/2, H/2) scale of the densify statistics",
    "sync/compose_constants": ("models.renderer.compose_frame: the identity pose, the flip's mirror and "
                               "quaternion, the sky sphere's centre, a host include mask"),
    "sync/sky_constants": "models.sky_cubemap._combine_taps: the lane tables of the sky lookup",
    "sync/camera_inverse": "utils.camera.camera_rays: linalg.inv of K reads its error flag back",
    "sync/densify_constants": ("optim.densify: the models' first rows, the thresholds, the sphere centre, "
                               "the reset's opacity cap"),
    "sync/densify_counts": ("optim.densify.densify_and_prune: the free and new rows counted a model (a "
                            "mask's length, bincount's largest id)"),
    "sync/densify_fill": "optim.densify.densify_and_prune: zero moments and the alive flag written into the new rows",
    "sync/table_plan": "ops.tile_raster: the dense table's work-list counts read back to size the launches",
    "sync/step_scalars": "runner.training: the step's scalars read back every 10 iterations",
}


def span(name: str):
    """A record_function range `name` while a profiler session is
    active, else a shared null context. Use as `with span(name):`."""
    if _profiler_enabled():
        return torch.profiler.record_function(name)
    return _NULL


def profiler(device) -> torch.profiler.profile:
    """A profiler session of the host and, on a CUDA device, the card;
    enter it (or start and stop it), then `export_chrome_trace`."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def load_events(path: str) -> list:
    with open(path) as f:
        return json.load(f)["traceEvents"]


def device_events(events: list) -> list:
    """A Chrome trace's kernel, copy and set events, by start time."""
    return sorted(
        (e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset") and "dur" in e),
        key=lambda e: e["ts"],
    )


def busy_intervals(dev: list) -> List[list]:
    """The union of the device events' intervals, [[start, end]] in us."""
    out: List[list] = []
    for e in dev:
        a, b = e["ts"], e["ts"] + e["dur"]
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def busy_ms(dev: list) -> float:
    """The union of the device events' intervals, in ms."""
    return sum(b - a for a, b in busy_intervals(dev)) / 1e3


def host_syncs(events: list) -> list:
    """The host's stream and device synchronisations in a trace."""
    return [e for e in events if e.get("cat") == "cuda_runtime"
            and e.get("name") in ("cudaStreamSynchronize", "cudaDeviceSynchronize")]


def host_spans(events: list, prefix: str = SYNC_PREFIX) -> list:
    """The host ranges whose names start with `prefix`."""
    return [e for e in events if e.get("cat") == "user_annotation" and "dur" in e
            and e.get("name", "").startswith(prefix)]


def trace_summary(trace_path: str, wall_ms: float, views: int, stages=STAGES) -> dict:
    """From a Chrome trace of `views` views (or steps) that took
    `wall_ms` on the host: the device's busy time (union of kernel, copy
    and set intervals, over all the views, as wall_ms is) and idle
    share, and per view and stage (profiler range name) the device span,
    the kernel time and count inside it, the kernel time and count
    launched (from any host thread) while the host range was open, the
    host time and the host's stream synchronisations; plus the kernels
    that took the most time. The launched counts see the backward, whose
    kernels autograd launches from its own thread outside the device span
    of the range."""
    events = load_events(trace_path)
    dev = device_events(events)
    busy_us = busy_ms(dev) * 1e3
    runtime = [e for e in events if e.get("cat") == "cuda_runtime"]
    syncs = host_syncs(events)
    launch_ts = {e["args"]["correlation"]: e["ts"] for e in runtime if "correlation" in e.get("args", {})}
    launched = [(launch_ts[k["args"]["correlation"]], k["dur"]) for k in dev
                if k.get("cat") == "kernel" and k.get("args", {}).get("correlation") in launch_ts]
    per = {k: dict(span_ms=0.0, kernel_ms=0.0, kernels=0, launched_kernel_ms=0.0, launched_kernels=0,
                   host_ms=0.0, host_syncs=0) for k in stages}
    for e in events:
        st = per.get(e.get("name"))
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
            inside = [d for t, d in launched if lo <= t <= hi]
            st["launched_kernel_ms"] += sum(inside) / 1e3
            st["launched_kernels"] += len(inside)
    for st in per.values():
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
        "per_view": per,
        "top_kernels_per_view": [{"name": n, "ms": t, "launches": c} for n, (t, c) in top],
    }


def sync_sites(events: list, steps: int) -> dict:
    """Per step (or view), for each `sync/` span name: the host's syncs
    inside it (on its thread) and the device's idle ms in the gaps of
    the union of device intervals that begin while it is open (the
    innermost such span); "outside" counts the syncs in no `sync/` span
    and the idle that begins in none."""
    spans = host_spans(events)
    out: Dict[str, Dict[str, float]] = {}

    def site(name: str) -> Dict[str, float]:
        return out.setdefault(name, {"syncs": 0.0, "idle_ms": 0.0})

    for y in host_syncs(events):
        inside = [s for s in spans if s.get("tid") == y.get("tid") and s["ts"] <= y["ts"] <= s["ts"] + s["dur"]]
        site(min(inside, key=lambda s: s["dur"])["name"] if inside else "outside")["syncs"] += 1 / steps
    iv = busy_intervals(device_events(events))
    for (_, a), (b, _) in zip(iv, iv[1:]):
        inside = [s for s in spans if s["ts"] <= a <= s["ts"] + s["dur"]]
        site(min(inside, key=lambda s: s["dur"])["name"] if inside else "outside")["idle_ms"] += (b - a) / 1e3 / steps
    return dict(sorted(out.items()))


def trace_stats(trace_path: str, steps: int, kernels: Sequence[str] = ()) -> dict:
    """Totals per step (or view) of a trace: the device's busy ms, the
    kernels, the host's syncs, the ms and launches of the kernels whose
    names hold each of `kernels`, and `sync_sites`."""
    events = load_events(trace_path)
    dev = device_events(events)
    launched = [e for e in dev if e.get("cat") == "kernel"]
    named = {}
    for key in kernels:
        hits = [e for e in launched if key in e["name"]]
        named[key] = {"ms": sum(e["dur"] for e in hits) / 1e3 / steps, "launches": len(hits) / steps}
    return {"busy_ms": busy_ms(dev) / steps, "kernels": len(launched) / steps,
            "host_syncs": len(host_syncs(events)) / steps, "named": named,
            "sync_sites": sync_sites(events, steps)}
