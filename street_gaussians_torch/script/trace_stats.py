"""Totals per step (or view) of a profiler trace written by `python -m
street_gaussians_torch.train --profile`, `serve --profile`,
`train.trace_dir` or `render.trace_dir`: the device's busy ms, the
kernels, the host's synchronisations, the ms and launches of the
kernels whose names hold each given string, and per `sync/` span the
syncs and the device's idle ms that begin in it (utils.trace).

    python -m street_gaussians_torch.script.trace_stats TRACE.json --steps 5
        [--kernel segsum expand_runs ...]

It reads the trace only, so one version of it compares traces that two
versions of the port wrote (parent and change, in turns).
"""

from __future__ import annotations

import argparse
import json

from street_gaussians_torch.utils.trace import trace_stats


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trace")
    ap.add_argument("--steps", type=int, required=True, help="steps or views the trace holds")
    ap.add_argument("--kernel", nargs="*", default=[], help="substrings of kernel names to total")
    args = ap.parse_args(argv)
    print(json.dumps({"trace": args.trace, "per_step": trace_stats(args.trace, args.steps, args.kernel)}))


if __name__ == "__main__":
    main()
