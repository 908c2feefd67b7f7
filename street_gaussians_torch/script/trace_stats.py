"""Totals per step (or view) of a profiler trace written by `python -m
street_gaussians_torch.train --profile` or `serve --profile`: the
device's busy ms, the kernels, the host's synchronisations, and the ms
and launches of the kernels whose names hold each given string.

    python -m street_gaussians_torch.script.trace_stats TRACE.json --steps 5
        [--kernel segsum expand_runs ...]

It reads the trace only, so one version of it compares traces that two
versions of the port wrote (parent and change, in turns).
"""

from __future__ import annotations

import argparse
import json

from street_gaussians_torch.serve import busy_ms, device_events, host_syncs


def trace_stats(trace_path: str, steps: int, kernels=()) -> dict:
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    dev = device_events(events)
    launched = [e for e in dev if e.get("cat") == "kernel"]
    named = {}
    for key in kernels:
        hits = [e for e in launched if key in e["name"]]
        named[key] = {"ms": sum(e["dur"] for e in hits) / 1e3 / steps, "launches": len(hits) / steps}
    return {"busy_ms": busy_ms(dev) / steps, "kernels": len(launched) / steps,
            "host_syncs": len(host_syncs(events)) / steps, "named": named}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trace")
    ap.add_argument("--steps", type=int, required=True, help="steps or views the trace holds")
    ap.add_argument("--kernel", nargs="*", default=[], help="substrings of kernel names to total")
    args = ap.parse_args(argv)
    print(json.dumps({"trace": args.trace, "per_step": trace_stats(args.trace, args.steps, args.kernel)}))


if __name__ == "__main__":
    main()
