"""What the readers of the program's finer spans share: kernel ms a step
launched inside some host ranges and outside others, and the device's
idle ms a step in gaps that begin while a `sync/` span is open.

Reads only what harness/trace.py offers (host_ranges, launched kernels,
busy_intervals of the profiled stretch's device events). A program
without these spans (an older commit) gives None, not 0.
"""

from __future__ import annotations

from typing import Optional, Sequence

from benchmark.harness import trace as tr

SYNC_PREFIX = "sync/"
# the spans the program opens inside custom autograd Functions' backward
BWD_SPANS = ("tile_blend_bwd", "payload_bwd", "sky_bwd", "rows_bwd")


def _ranges(events: list, names: Sequence[str]) -> list:
    return [r for n in names for r in tr.host_ranges(events, n)]


def launched_ms(ctx, inside: Sequence[str], outside: Sequence[str] = ()) -> Optional[float]:
    """Kernel ms a step launched (from any host thread) while one of the
    ranges `inside` was open and none of `outside`; None when no range
    of `inside`, or none of a given `outside`, opened."""
    t = ctx["trace"]
    ins, outs = _ranges(t["events"], inside), _ranges(t["events"], outside)
    if not ins or (outside and not outs):
        return None
    ms = sum(k["dur"] for ts, k in t["launched"]
             if any(lo <= ts <= hi for lo, hi in ins) and not any(lo <= ts <= hi for lo, hi in outs))
    return ms / 1e3 / ctx["steps"]


def sync_idle_ms(ctx) -> Optional[float]:
    """Device idle ms a step in the gaps of the union of the profiled
    stretch's device intervals that begin while a `sync/` span is open
    on the host (any thread); None when the trace holds no such span."""
    t = ctx["trace"]
    names = {e["name"] for e in t["events"]
             if e.get("cat") == "user_annotation" and str(e.get("name", "")).startswith(SYNC_PREFIX)}
    spans = _ranges(t["events"], sorted(names))
    if not spans:
        return None
    iv = tr.busy_intervals(t["dev"])
    idle = sum(b - a for (_, a), (b, _) in zip(iv, iv[1:]) if any(lo <= a <= hi for lo, hi in spans))
    return idle / 1e3 / ctx["steps"]
