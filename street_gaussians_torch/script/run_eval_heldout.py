"""The held-out-split eval closure: build the 1600x1064 demo scene, train
2,000 iterations with every 4th frame held out (split_test 4), render
both splits and score them.

    python -m street_gaussians_torch.script.run_eval_heldout [--device D] [--scene DIR]
        [--model_path DIR] [KEY VALUE ...]

The repo's root script/run_eval_heldout.sh in Python, through the port:
make_demo_scene (16 frames of camera 0 at 1064x1600, 150,000 LiDAR
points) into --scene when its images/ are missing, then the train,
render and metrics CLIs on configs/eval_heldout.yaml with source_path
and model_path set to --scene and --model_path and the KEY VALUE
overrides after them; prints results_test.json and results_train.json
(per-view PSNR and SSIM, the reference's metrics.py:76-98 protocol).
Paths default to data/eval_scene and output/demo/eval_heldout under the
repo's root. Runs on the CUDA card unless --device says otherwise.
"""

from __future__ import annotations

import argparse
import json
import os
import time

from street_gaussians_torch import metrics as metrics_cli
from street_gaussians_torch import render as render_cli
from street_gaussians_torch import train as train_cli
from street_gaussians_torch.script.make_demo_scene import make_demo_scene

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CONFIG = os.path.join(ROOT, "configs", "eval_heldout.yaml")
SCENE = dict(frames=16, cameras=(0,), height=1064, width=1600, points=150_000)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    ap.add_argument("--scene", default=os.path.join(ROOT, "data", "eval_scene"))
    ap.add_argument("--model_path", default=os.path.join(ROOT, "output", "demo", "eval_heldout"))
    ap.add_argument("opts", nargs=argparse.REMAINDER, help="KEY VALUE overrides for the three CLIs")
    args = ap.parse_args(argv)
    dev = ["--device", args.device] if args.device else []
    opts = ["source_path", args.scene, "model_path", args.model_path, *args.opts]
    seconds = {}
    t0 = time.perf_counter()
    if not os.path.isdir(os.path.join(args.scene, "images")):
        make_demo_scene(args.scene, **SCENE, device=args.device)
    seconds["scene_s"] = time.perf_counter() - t0
    for name, cli in (("train", train_cli), ("render", render_cli), ("metrics", metrics_cli)):
        print(f"=== {name} ===", flush=True)
        t0 = time.perf_counter()
        cli.main(["--config", CONFIG, *dev, *opts])
        seconds[f"{name}_s"] = time.perf_counter() - t0
    results = {}
    for split in ("test", "train"):
        path = os.path.join(args.model_path, f"results_{split}.json")
        if os.path.exists(path):
            with open(path) as f:
                results[split] = json.load(f)
            print(f"{path}: {json.dumps(results[split])}", flush=True)
    print(f"=== DONE === {json.dumps(seconds)}", flush=True)
    return {"results": results, "seconds": seconds}


if __name__ == "__main__":
    main()
