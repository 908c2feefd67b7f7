"""Readings for the static scene's cell (harness/orbit.py), on the card,
one process.

    python3 benchmark/calibrate_orbit.py --workload <cell> --seeds S1 S2 ... [--instances | --no-faults]

--instances: the (Gaussian, tile) instances binning generates for every
view of the scene at the snapshot (the preprocess's tiles touched,
summed), a line a seed: the largest, on which render.instance_capacity
is set (the watchdog's doubling ladder from the port's 2,097,152).
Otherwise, for each seed: the program's numbers of `correct` against
reference/sh.py, the control's (the reference with its matrix products
in TF32) and the planted faults' (the loss over half the image, a state
left unchanged), then the largest program reading and the smallest
control and fault readings of each number, and whether each side
passes the cell's limits (harness/orbit.LIMITS); --no-faults: the
program and the control alone. The benchmark's runs never
run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def instances(cell, seed, dev) -> dict:
    import torch

    from street_gaussians_torch.models.renderer import screen_space

    from benchmark.harness import orbit
    from benchmark.harness.orbit_scene import make_scene

    scene = make_scene(cell.config["scene"], seed, dev)
    prog = orbit.build(scene, cell.config["recipe"], {}, dev)
    st = prog.state
    counts = []
    for frame in prog.frames:
        with torch.no_grad():
            screen, _ = screen_space(st.params, st.aux, prog.table, None, frame, st.step, prog.opts_train)
        counts.append(int(screen.tiles_touched.sum()))
    ladder = 2_097_152
    while ladder < max(counts):
        ladder *= 2
    return {"max": max(counts), "min": min(counts), "mean": sum(counts) / len(counts),
            "argmax": counts.index(max(counts)), "ladder": ladder, "counts": counts}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--instances", action="store_true")
    ap.add_argument("--no-faults", action="store_true")
    args = ap.parse_args(argv)
    import torch

    from benchmark.harness import check, manifest, orbit

    cell = manifest.find_cell(args.workload)
    if not torch.cuda.is_available():
        print("calibrate_orbit.py: needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    rows = []
    for seed in args.seeds:
        t0 = time.perf_counter()
        r = instances(cell, seed, dev) if args.instances else orbit.readings(cell, seed, dev, not args.no_faults)
        r["seed"], r["seconds"] = seed, time.perf_counter() - t0
        rows.append(r)
        print(json.dumps(r), flush=True)
        torch.cuda.empty_cache()
    if not args.instances:
        summary, passed = {}, {}
        for side, pick in (("program", max), ("control", min), ("fault_half_batch", min), ("fault_unchanged", min)):
            if side in rows[0]:
                summary[side] = {k: pick(r[side][k] for r in rows) for k in rows[0][side]}
                passed[side] = [check.judge(r[side], orbit.LIMITS)[0] for r in rows]
        print(json.dumps({"summary": summary, "passes": passed, "seeds": args.seeds}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
