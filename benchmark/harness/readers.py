"""What the per-layer readers (layer_metrics/*.py) share: a range's
kernel time a step, the roofline shares of the blend and row-sum
kernels, the idle share, the step's share of the card's peak.

`ctx` is the traced run's: "trace" (harness/trace.summarize_events over
the profiled stretch), "steps" (steps or views profiled), "work" (the
counted work a step or view, harness/counts), "unprofiled_s" (seconds a
step or view in the unprofiled window), "densify_s" (the densify calls'
synchronised seconds a window step, train only).
"""

from __future__ import annotations

from typing import Optional

from benchmark.harness import counts
from benchmark.harness import trace as tr

# the CUDA kernels of each source, by name
FWD_KERNELS = ("plan_kernel", "block_sums_kernel", "blend_items_kernel", "combine_kernel",
               "blend_items_wide_kernel", "combine_wide_kernel")
BWD_KERNELS = ("tile_blend_bwd_kernel", "tile_blend_bwd_wide_kernel")
SEGSUM_KERNELS = ("segsum_tiles_kernel", "segsum_fixup_kernel", "segment_ranges_kernel")


def range_ms(ctx, name: str) -> Optional[float]:
    """Kernel ms a step launched while the program's range `name` was
    open; None when the range never opened."""
    r = tr.range_kernels(ctx["trace"]["events"], name, launched=ctx["trace"]["launched"])
    if r["ranges"] == 0 or r["kernels"] == 0:
        return None
    return r["ms"] / ctx["steps"]


def idle_share(ctx) -> Optional[float]:
    """1 - the device's busy time a step (the union of its intervals in
    the profiled stretch) over the unprofiled window's time a step, in
    %: the profiler's own host cost stays out of the wall time."""
    t = ctx["trace"]
    if t["busy_ms"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_ms"] / ctx["steps"] / (1e3 * ctx["unprofiled_s"]))


def syncs_per_step(ctx) -> float:
    return ctx["trace"]["syncs"] / ctx["steps"]


def blend_fwd_roofline(ctx) -> Optional[float]:
    r = tr.range_kernels(ctx["trace"]["events"], "tile_blend", FWD_KERNELS, launched=ctx["trace"]["launched"])
    w = ctx["work"]
    if r["kernels"] == 0 or w["evaluated"] <= 0:
        return None
    work = counts.blend_fwd_work(w["evaluated"], w["blended"], w["live"], w["tiles"])
    return counts.roofline_share(work, r["ms"] / ctx["steps"] / 1e3)


def blend_bwd_roofline(ctx) -> Optional[float]:
    r = tr.named_kernels(ctx["trace"]["events"], BWD_KERNELS, dev=ctx["trace"]["dev"])
    w = ctx["work"]
    if r["kernels"] == 0 or w["evaluated"] <= 0:
        return None
    work = counts.blend_bwd_work(w["evaluated"], w["blended"], w["live"], w["tiles"])
    return counts.roofline_share(work, r["ms"] / ctx["steps"] / 1e3)


def segsum_roofline(ctx) -> Optional[float]:
    r = tr.named_kernels(ctx["trace"]["events"], SEGSUM_KERNELS, dev=ctx["trace"]["dev"])
    w = ctx["work"]
    if r["kernels"] == 0:
        return None
    n = ctx["steps"]
    byt = sum(counts.payload_segsum_work(live, w["capacity"])["bytes"] for live in w["payload_live"]) / n
    ops = sum(counts.payload_segsum_work(live, w["capacity"])["ops"] for live in w["payload_live"]) / n
    if w["texels"]:
        sky = counts.sky_segsum_work(int(w["sky_pixels"]), w["texels"])
        byt, ops = byt + sky["bytes"], ops + sky["ops"]
    return counts.roofline_share({"ops": ops, "bytes": byt}, r["ms"] / n / 1e3)


def mfu(ctx) -> Optional[float]:
    w = ctx["work"]
    ops = counts.step_ops(w) if ctx["kind"] == "train" else counts.view_ops(w)
    return 100.0 * ops / (ctx["unprofiled_s"] * counts.F32_PEAK)
