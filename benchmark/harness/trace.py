"""Reading a torch.profiler Chrome trace: the arithmetic the per-layer
metrics share.

Copied from the program's serve.py (`device_events`, `busy_ms`,
`host_syncs`, `trace_summary`) and script/trace_stats.py, frozen here so
that a change to the program cannot move the yardstick: the device's
busy time is the union of its kernel, copy and set intervals; a range's
kernel time is that of the kernels launched, from any host thread,
while the range was open on the host (autograd launches the backward's
kernels from its own thread); the host's syncs are its stream and
device synchronisations.
"""

from __future__ import annotations

import json
from typing import Dict, Iterable, List, Optional, Sequence


def load_events(path: str) -> list:
    with open(path) as f:
        return json.load(f)["traceEvents"]


def device_events(events: list) -> list:
    """The kernel, copy and set events, by start time."""
    return sorted((e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset") and "dur" in e),
                  key=lambda e: e["ts"])


def busy_intervals(dev: list) -> List[tuple]:
    """The union of the device events' intervals, [(start, end)] in us."""
    out: List[list] = []
    for e in dev:
        a, b = e["ts"], e["ts"] + e["dur"]
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [tuple(x) for x in out]


def busy_ms(dev: list) -> float:
    return sum(b - a for a, b in busy_intervals(dev)) / 1e3


def host_syncs(events: list) -> list:
    return [e for e in events if e.get("cat") == "cuda_runtime"
            and e.get("name") in ("cudaStreamSynchronize", "cudaDeviceSynchronize")]


def launched_kernels(events: list, dev: Optional[list] = None) -> list:
    """[(launch ts on the host, kernel event)] of every kernel."""
    dev = device_events(events) if dev is None else dev
    launch_ts = {e["args"]["correlation"]: e["ts"] for e in events
                 if e.get("cat") == "cuda_runtime" and "correlation" in e.get("args", {})}
    return [(launch_ts[k["args"]["correlation"]], k) for k in dev
            if k.get("cat") == "kernel" and k.get("args", {}).get("correlation") in launch_ts]


def host_ranges(events: list, name: str) -> List[tuple]:
    """[(start, end)] in us of the host's record_function ranges `name`."""
    return [(e["ts"], e["ts"] + e["dur"]) for e in events
            if e.get("cat") == "user_annotation" and e.get("name") == name and "dur" in e]


def range_kernels(events: list, name: str, patterns: Sequence[str] = (), launched=None) -> Dict[str, float]:
    """Kernels launched while the host range `name` was open (names
    holding one of `patterns`, if given): {"ms", "kernels", "syncs"}."""
    launched = launched_kernels(events) if launched is None else launched
    spans = host_ranges(events, name)
    syncs = host_syncs(events)
    ms, n = 0.0, 0
    for t, k in launched:
        if any(lo <= t <= hi for lo, hi in spans) and (not patterns or any(p in k["name"] for p in patterns)):
            ms += k["dur"] / 1e3
            n += 1
    return {"ms": ms, "kernels": n, "syncs": sum(any(lo <= y["ts"] <= hi for lo, hi in spans) for y in syncs),
            "ranges": len(spans)}


def named_kernels(events: list, patterns: Iterable[str], dev: Optional[list] = None) -> Dict[str, float]:
    """All kernels whose names hold one of `patterns`: {"ms", "kernels"}."""
    dev = device_events(events) if dev is None else dev
    hits = [e for e in dev if e.get("cat") == "kernel" and any(p in e["name"] for p in patterns)]
    return {"ms": sum(e["dur"] for e in hits) / 1e3, "kernels": len(hits)}


def top_ops(dev: list, n: int = 10) -> list:
    """[[name, seconds]] of the device operations that took most time."""
    by: Dict[str, float] = {}
    for e in dev:
        by[e["name"][:120]] = by.get(e["name"][:120], 0.0) + e["dur"] / 1e6
    return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def idle_gaps(events: list, dev: list, lo: float, hi: float, n: int = 10) -> list:
    """[[what the host was doing, seconds]] of the longest gaps between
    device work inside [lo, hi] us: the innermost host range open at the
    gap's start (the profiler's step ranges aside), or "host"."""
    iv = [(a, b) for a, b in busy_intervals(dev) if b > lo and a < hi]
    gaps, t = [], lo
    for a, b in iv:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if hi > t:
        gaps.append((t, hi))
    ranges = [e for e in events if e.get("cat") == "user_annotation" and "dur" in e
              and not e.get("name", "").startswith("ProfilerStep")]
    out = []
    for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:n]:
        open_ = [e for e in ranges if e["ts"] <= a <= e["ts"] + e["dur"]]
        name = min(open_, key=lambda e: e["dur"])["name"] if open_ else "host"
        out.append([name, (b - a) / 1e6])
    return out


def summarize_events(events: list, lo_us: float, hi_us: float) -> dict:
    """Everything the per-layer readers take from one trace, over the
    stretch [lo_us, hi_us] of the trace's clock."""
    dev = [e for e in device_events(events) if lo_us <= e["ts"] <= hi_us]
    return {"events": events, "dev": dev, "launched": launched_kernels(events, dev), "busy_ms": busy_ms(dev),
            "window_ms": (hi_us - lo_us) / 1e3,
            "syncs": sum(lo_us <= y["ts"] <= hi_us for y in host_syncs(events)),
            "kernels": sum(e.get("cat") == "kernel" for e in dev), "lo_us": lo_us, "hi_us": hi_us}
