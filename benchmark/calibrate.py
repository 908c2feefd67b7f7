"""Readings for the limits of `correct`, on the card, one process.

    python3 benchmark/calibrate.py --workload <cell> --seeds S1 S2 ... [--seconds 12]

For each seed: the program's numbers against the plain reference (the
lower readings), the control's (the reference with its matrix products
in TF32, the precision below the configuration's float32 with TF32
off) against the reference, and planted faults' against the reference
(train: the loss over half the image, the mean over the rest; a step
that returns its state unchanged; the densify round's thresholds
doubled; serve: one 16x16 tile of the answer altered, in rgb, acc and
depth or in rgb alone). --control-seeds of the seeds read the control
and the faults, the rest the program alone (--no-serve-control: the
serve cells' faults without the control). One JSON line a seed, then a
summary: the largest program reading and the smallest control and fault
readings of each number. The benchmark's runs never run this.
"""

from __future__ import annotations

import argparse
import statistics
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def train_readings(cell, seed, dev, faults: bool = True):
    import torch

    from benchmark.harness import check, loops

    S = loops.TrainSetup(cell, seed, dev)
    state, rec, pl, pg, pdp = S.checked_steps(cell.traffic["checked_steps"])
    dens = S.checked_densify(state, seed) if S.densify_at_cycle_end() else None
    scene, cfg, start, it = S.scene, S.cfg, S.start_it, S.start_it + S.cycle
    truths = {i: S.truths[i] for i, _, _ in rec}
    del S, state
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    stats = dens is not None
    ref = loops.reference_train(scene, cfg, start, rec, truths, statistics=stats)
    ref_round = loops.reference_densify(scene, cfg, it, ref, dens[1]) if stats else None

    def numbers(r, side):
        """A reference run in the program's place (r its steps, side its round) against the reference."""
        n = check.train_numbers(r.losses, ref.losses, r.g, ref.g, r.dp, ref.dp)
        if stats:
            n.update({"stats_gap": max(check.stats_gaps(r.stats, ref.stats).values()),
                      "densify_gap": max(check.densify_parts(side, ref_round).values())})
        return n

    out = {"program": check.train_numbers(pl, ref.losses, pg, ref.g, pdp, ref.dp)}
    if stats:
        side = dens[0]
        out["program"].update(check.densify_numbers(side, ref.stats, ref_round))
        out["program_densify"] = {"stats": check.stats_gaps(side["stats"], ref.stats),
                                  "parts": check.densify_parts(side, ref_round),
                                  "ref_clone": ref_round["n_clone"], "ref_split": ref_round["n_split"],
                                  "ref_removed": int(ref_round["removed"].sum())}
    if faults:
        for name, kw in (("control", {"tf32": True}), ("fault_half_batch", {"half": True}),
                         ("fault_unchanged", {"frozen": True})):
            r = loops.reference_train(scene, cfg, start, rec, truths, statistics=stats, **kw)
            rnd = loops.reference_densify(scene, cfg, it, r, dens[1]) if stats else None
            out[name] = numbers(r, _side(scene, r, rnd) if stats else None)
            del r, rnd
        if stats:
            thr = loops.reference_densify(scene, cfg, it, ref, dens[1], threshold_scale=2.0)
            out["fault_densify_threshold"] = {
                "stats_gap": 0.0, "densify_gap": max(check.densify_parts(_side(scene, ref, thr), ref_round).values())}
    keys = sorted(ref.g)
    med = statistics.median(ref.g[k] for k in keys)
    moving = [k for k in keys if ref.g[k] >= 1e-3 * med]
    out["program_leaves"] = {"grad": check.leaf_gaps(pg, ref.g, keys), "change": check.leaf_gaps(pdp, ref.dp, moving)}
    out["ref_grad_norms"] = ref.g
    out["ref_change_norms"] = ref.dp
    return out


def _side(scene, r, rnd):
    """A reference round on its own steps' parameters, as densify_parts
    reads the program's: the rows before the round, after it."""
    return {"alive0": scene.alive, "xyz0": r.params["gaussians.xyz"], "alive": rnd["alive"], "xyz": rnd["xyz"],
            "log_scale": rnd["log_scale"], "n_split": rnd["n_split"]}


def serve_readings(cell, seed, dev, seconds, faults: bool = True, control: bool = True):
    import torch

    from benchmark.harness import check, loops
    from benchmark.reference.render import precise, render
    from benchmark.reference.train import initial_state

    out = {}
    for fault in (None, "tile", "tile_rgb") if faults else (None,):
        o = loops.run_serve(cell, seed, seconds, False, dev, time.perf_counter(), fault=fault)
        out["program" if fault is None else f"fault_{fault}"] = o.numbers
    if not (faults and control):
        return out
    # the control: the reference in TF32 against the reference, same views
    from benchmark.harness.scene import make_generator, make_scene

    cfg = cell.config
    scene = make_scene(cfg["scene"], seed, dev, iteration=cfg["scene"]["snapshot_iteration"])
    g = make_generator(seed, torch.device("cpu"), stream=5)
    views = loops.served_views(scene, cell.traffic["views"])
    sample = [views[k] for k in loops.sample_views(len(views), cell.traffic["sample_views"], g)]
    p = initial_state(scene)["params"]
    wb = bool(cfg["recipe"]["data"].get("white_background", False))
    worst = {}
    for i in sample:
        with torch.no_grad():
            precise(True)
            ref = render(scene, p, scene.views[i], train=False, white_background=wb)
            precise(False)
            ctl = render(scene, p, scene.views[i], train=False, white_background=wb)
            precise(True)
        for k, v in check.view_numbers(check.to_uint8(ctl["rgb"]), ctl["acc"], ctl["depth"], ref).items():
            worst[k] = max(worst.get(k, 0.0), v)
    out["control"] = worst
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=12.0)
    ap.add_argument("--control-seeds", type=int, default=3,
                    help="how many of the seeds (the first) also read the control and the faults")
    ap.add_argument("--no-serve-control", action="store_true",
                    help="serve cells: read the faults without the control")
    args = ap.parse_args(argv)
    import torch

    from benchmark.harness import manifest

    cell = manifest.find_cell(args.workload)
    if not torch.cuda.is_available():
        print("calibrate.py: needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    rows = []
    for k, seed in enumerate(args.seeds):
        t0 = time.perf_counter()
        faults = k < args.control_seeds
        r = (train_readings(cell, seed, dev, faults) if "checked_steps" in cell.traffic
             else serve_readings(cell, seed, dev, args.seconds, faults, not args.no_serve_control))
        r["seed"], r["seconds"] = seed, time.perf_counter() - t0
        rows.append(r)
        print(json.dumps(r), flush=True)
    summary = {}
    for side, pick in (("program", max), ("control", min), ("fault_half_batch", min), ("fault_unchanged", min),
                       ("fault_densify_threshold", min), ("fault_tile", min), ("fault_tile_rgb", min)):
        vals = [r[side] for r in rows if side in r]
        if vals:
            summary[side] = {k: pick(v[k] for v in vals) for k in vals[0]}
    print(json.dumps({"summary": summary, "seeds": args.seeds}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
