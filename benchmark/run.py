"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (scene and ground truth from the seed, the program built, the
checked first steps, a warm-up), a window of --seconds, then with
--trace 1 a profiled stretch for the per-layer metrics, and last the
comparison with the plain reference that decides `correct`. The last
line of standard output is one JSON object (correct, attempted, failed,
metrics, device, with --trace 1 breakdown, and the compared numbers
beside their limits under "check"); the compared numbers are also the
last lines of standard error. Needs a CUDA card: without one, or with
fewer cards than the cell asks for, it exits non-zero and prints no
result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

FORBIDDEN = ("jax", "jaxlib", "flax", "street_gaussians_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one the run must not load."""
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


def power_limit() -> str:
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                           capture_output=True, text=True, timeout=30)
        return r.stdout.strip().splitlines()[0] if r.returncode == 0 and r.stdout.strip() else ""
    except (OSError, subprocess.SubprocessError):
        return ""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from benchmark.harness import check, manifest

    cell = manifest.find_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"run.py: {cell.name} needs {cell.chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    loop = manifest.loop(cell.traffic["loop"])
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    out = loop.run(cell, args.seed, args.seconds, bool(args.trace), dev, T_START)

    correct, rows = check.judge(out.numbers, out.limits)
    if args.trace:
        metrics = {}
        for m in cell.per_layer:
            v = manifest.reader(m["name"])(out.layer_ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        values = dict(out.e2e, setup_s=out.setup_s, peak_mem_gib=out.peak_bytes / 2**30)
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]} for m in cell.end_to_end}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev), "count": 1,
              "memory_peak_bytes": int(out.peak_bytes), "power_limit": power_limit()}
    result = {"correct": bool(correct), "attempted": int(out.attempted), "failed": int(out.failed),
              "metrics": metrics, "device": device}
    if args.trace:
        device["busy_s"] = out.device["busy_s"]
        device["window_s"] = out.device["window_s"]
        result["breakdown"] = out.device["breakdown"]
    result["window_s"] = out.window_s
    result["check"] = {name: {"value": v, "limit": lim} for name, v, lim in rows}
    return finish(result, rows)


def finish(result: dict, rows) -> int:
    """Print the compared numbers beside their limits on standard error
    and the result line on standard output; 0. Where a module that the
    run must not load is loaded now (the window, the readers and the
    check have run), name it on standard error, print no result, 3."""
    bad = forbidden_modules()
    if bad:
        print(f"run.py: modules that the run must not load were loaded: {bad}", file=sys.stderr)
        return 3
    for name, v, lim in rows:
        print(f"check {name} {v!r} limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
