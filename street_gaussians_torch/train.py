"""Training: a scene from a YAML config, or the bench train cell.

    python -m street_gaussians_torch.train --config CONFIG.yaml [--device D] [KEY VALUE ...]

runs runner.training on the config (the JAX package's root train.py):
defaults, then the YAML file with its parents, then the KEY VALUE
overrides; checkpoints, PLY snapshots and train_log.jsonl land under
model_path. Under torchrun the ranks form a process group from its
environment before the scene is built, each on cuda:LOCAL_RANK (cuda:0
when the host has one card, shared by its ranks), and train together:

    torchrun --standalone --nproc_per_node B -m street_gaussians_torch.train \
        --config CONFIG.yaml train.batch_size B

(or train.tile_shards B: one band a rank; train.gauss_shards B: the
table's rows in B blocks, one a rank); rank 0 alone writes. Several
hosts (one machine standing for two: --master_addr 127.0.0.1, the ranks
then share its cards over Gloo), each training on its own slice of the
views:

    torchrun --nnodes 2 --node_rank I --nproc_per_node L --master_addr A --master_port P \
        -m street_gaussians_torch.train --config CONFIG.yaml train.multihost true train.batch_size 2

Every rank prints its final numbers on a `[train] final {...}` line.
Without --config:

    python -m street_gaussians_torch.train [--steps N] [--device cuda]
        [--profile TRACE.json]

builds bench.py's train cell (1600x1064, 220k background points grown
x3 = 661,248 rows, 4 actors, a 1024 sky cubemap at its constant
initialisation; L1 + DSSIM, sky BCE at 0.05, trimmed LiDAR depth at
0.1; every instance kept), renders the ground truth of frames[2] in eval
mode, runs 3 warm-up steps and then --steps timed steps on that camera,
and prints one JSON line per timed step (loss, psnr, overflow, ms) and a
summary. Densify and the opacity reset run at the config's intervals.
--profile traces the timed steps with torch.profiler, writes the Chrome
trace there and adds the device's busy time, idle share and a per-stage
breakdown (utils.trace.trace_summary plus the `losses`, `backward` and
`optimizer` ranges of train_lib) to the summary.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import time

import torch

from street_gaussians_torch import serve
from street_gaussians_torch._device import resolve_device
from street_gaussians_torch.config import default_config
from street_gaussians_torch.data.synthetic import make_synthetic_scene
from street_gaussians_torch.models.renderer import RenderOptions, SceneParams, render_frame
from street_gaussians_torch.models.sky_cubemap import init_sky
from street_gaussians_torch.train_lib import (
    GroundTruth,
    densify_cadence,
    init_train_state,
    make_densify_fn,
    make_reset_opacity_fn,
    make_train_step,
)
from street_gaussians_torch.utils import trace

GT_FRAME = 2
WARMUP = 3
STAGES = trace.STAGES + ("losses", "backward", "optimizer")


@dataclasses.dataclass
class TrainCell:
    scene: object
    state: object
    frame: object
    gt: GroundTruth
    cfg: object
    opts: RenderOptions
    step_fn: object
    densify_fn: object
    reset_fn: object


def bench_config():
    cfg = default_config()
    cfg.optim.lambda_sky = 0.05
    cfg.optim.lambda_depth_lidar = 0.1
    cfg.optim.lambda_reg = 0.0
    return cfg


def bench_train_cell(device=None, seed: int = 0, sky_resolution: int = serve.SKY_RESOLUTION,
                     **overrides) -> TrainCell:
    """bench.py's train cell on `device`; `overrides` replace entries of
    serve.BENCH_SCENE (tests and the small card check shrink it)."""
    device = resolve_device(device)
    scene = make_synthetic_scene(seed=seed, device=device, **{**serve.BENCH_SCENE, **overrides})
    params = SceneParams(
        gaussians=scene.params_init,
        actor_pose=scene.pose_params_init,
        sky=init_sky(sky_resolution, white_background=False, device=device),
        color_correction=None,
        pose_correction=None,
    )
    cap = serve.INSTANCE_CAPACITY
    opts = RenderOptions(mode="train", instance_capacity=cap, tile_capacity=cap)
    frame = scene.frames[GT_FRAME]
    H, W = frame.cam.H, frame.cam.W
    with torch.no_grad():
        image = render_frame(
            params, scene.aux, scene.table, scene.pose_data, frame, serve.SERVE_STEP,
            opts=dataclasses.replace(opts, mode="eval"),
        )["rgb"]
    gt = GroundTruth(
        image=image,
        mask=torch.ones((H, W, 1), dtype=torch.bool, device=device),
        sky_mask=torch.zeros((H, W, 1), dtype=torch.bool, device=device),
        lidar_depth=torch.full((H, W), 10.0, device=device),
        obj_bound=torch.zeros((H, W, 1), dtype=torch.bool, device=device),
        sky_scale=torch.ones((), device=device),
    )
    cfg = bench_config()
    return TrainCell(
        scene=scene, state=init_train_state(params, scene.aux), frame=frame, gt=gt, cfg=cfg,
        opts=opts, step_fn=make_train_step(cfg, scene.table, scene.pose_data, opts),
        densify_fn=make_densify_fn(cfg, scene.table), reset_fn=make_reset_opacity_fn(),
    )


def run_step(cell: TrainCell, state, generator):
    """One train step plus the reference's densify / reset cadence after
    it (train_lib.densify_cadence, with the step's 1-based number)."""
    state, scalars = cell.step_fn(state, cell.frame, cell.gt, generator)
    state, _ = densify_cadence(cell.cfg, state, state.step, cell.densify_fn, cell.reset_fn, generator)
    return state, scalars


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", default=None, help="train the scene of this YAML config (runner.training)")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    ap.add_argument("--profile", metavar="TRACE", default=None,
                    help="trace the timed steps and write a Chrome trace here")
    ap.add_argument("opts", nargs=argparse.REMAINDER, help="with --config: KEY VALUE overrides")
    args = ap.parse_args(argv)
    if args.config:
        from street_gaussians_torch.config import load_config
        from street_gaussians_torch.runner import training

        cfg = load_config(args.config, args.opts, "train")
        if int(os.environ.get("WORLD_SIZE", "1")) > 1:
            from street_gaussians_torch.parallel import comm

            group = comm.init_group(device=args.device)
            try:
                final = training(cfg, group=group)
            finally:
                comm.close_group()
        else:
            final = training(cfg, device=resolve_device(args.device))
        keys = ("param_checksum", "ema_loss", "ema_psnr", "num_alive", "start_iteration", "iterations", "host_views")
        # One write with its newline: under torchrun the ranks share a pipe, and
        # print's separate write of the end lets another rank's line land between.
        sys.stdout.write("[train] final " + json.dumps({k: final[k] for k in keys if k in final}) + "\n")
        sys.stdout.flush()
        return final
    if args.opts:
        ap.error(f"KEY VALUE overrides need --config: {args.opts}")

    device = resolve_device(args.device)
    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    cell = bench_train_cell(device, args.seed)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    state = cell.state
    for _ in range(WARMUP):
        state, _ = run_step(cell, state, gen)
    sync()
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    prof = trace.profiler(device) if args.profile else contextlib.nullcontext()
    times, records = [], []
    with prof:
        for _ in range(args.steps):
            t0 = time.perf_counter()
            state, scalars = run_step(cell, state, gen)
            sync()
            times.append((time.perf_counter() - t0) * 1e3)
            records.append(scalars)
    for i, sc in enumerate(records):
        print(json.dumps({
            "step": WARMUP + i + 1, "ms": times[i], "loss": float(sc["loss"]),
            "psnr": float(sc["psnr"]), "overflow": int(sc["overflow"]),
            "num_alive": int(sc["num_alive"]),
        }))
    summary = {
        "device": str(device), "name": torch.cuda.get_device_name(device) if cuda else "cpu",
        "steps": args.steps, "mean_ms": sum(times) / len(times),
        "peak_gib": torch.cuda.max_memory_allocated(device) / 2**30 if cuda else None,
        "capacity": cell.scene.table.capacity, "opts": dataclasses.asdict(cell.opts),
    }
    if args.profile:
        prof.export_chrome_trace(args.profile)
        summary["profile"] = trace.trace_summary(args.profile, sum(times), len(times), STAGES)
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
