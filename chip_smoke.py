#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card (H100).

    python3 chip_smoke.py

1. prints the card's name and power limit (nvidia-smi);
2. builds the hand-written CUDA kernels from street_gaussians_torch/csrc
   (seven sources holding eight kernels; one nvcc each, all started
   together), and beside them the probe build of the two main-path blend
   kernels that times their blocks (script.block_times) and the
   search-only probe build of the segmented row-sum and the run expansion
   (script.search_times);
3. holds each forward kernel against its plain PyTorch version on the
   card, on a random ragged case, on runs of up to 16,900 lanes that the
   blend splits into segments (pixels that stop in the first segment, in
   a later one and never) and on the bench frame's own inputs, where it
   also holds the blend's work list against its plain version and prints
   the run lengths and where the forward's blocks spend their time; and
   the whole serving path on a small scene against the CPU path;
4. serves the bench scene (1600x1064, 220k background points grown x3 =
   661,248 rows, 4 actors, 1024 sky cubemap) through serve.render_views:
   one warm-up view, then 8 timed views, which must be finite, drop no
   instance and go through both forward kernels (launch counters);
5. trains: holds the two backward kernels against their plain versions
   on a random case, on the long runs (with the forward's saved boundary
   state and without it: bit-equal) and on a bench train step's own
   inputs; runs two
   train steps of a small scene on the card and on the CPU with the same
   draws (gradients and parameters within the CPU tests' tolerances);
   trains the bench cell (train.bench_train_cell), 3 warm-up steps and
   10 timed steps, which must be finite, drop no instance, go through
   all four kernels and repeat bit for bit; then densify, reset and one
   more step; holds the segmented row-sum on the bench step's own two
   calls against its plain version and, bit for bit, against its order
   emulated on the CPU (ops.segsum.segment_rowsum_emulated), counts its
   launches per call, and times the two gradient steps around it stage
   by stage;
6. times kernels 1 to 4, their plain versions and a one-call PyTorch
   yardstick, and computes their bounds; times kernels 3 and 4 also in
   their search-only probe build (`[probe]` lines);
7. the dense-table layout and the blend probe: holds the table blend's
   forward and backward kernels and the probe's floor and tensor-core
   variants against their plain versions on a random case and on the
   bench frame's own inputs; runs the table-against-instance parity
   check (script.parity_check) on the bench frame and at its own
   880x1280 size, forward and gradients, which must agree, drop no
   instance and go through the table kernels and the segmented row-sum;
   runs the probe (script.probe_kernel) on the bench frame's payload;
   times the four and computes their bounds;
8. writes a Waymo-format sequence (data.synthetic_waymo, 10 frames of 3
   cameras at Waymo's 1280x1920, 25,000 LiDAR points a frame, the tracked
   vehicle in view), loads it with the port's loaders (1600x1067 views)
   and trains it with the Waymo recipe, object-opacity loss on: 3 warm-up
   steps, 10 timed steps before densify_until_iter and 10 after, which
   must be finite, drop no instance, launch the blend kernels twice a step
   after the gate and once before; one step at the gate repeats bit for
   bit, and the four main-path kernels are held against their plain
   versions on the inputs that step gave them, for the full render and
   for the object render (`[runs]` lines: their run lengths); the same
   views at the gate with and without the object loss, in turns, give
   the object render's cost; a profile of two steps on each side gives
   their device time, kernels and host syncs (`object_render` range);
   then two small train steps across the gate, card against CPU;
9. runs the port's three CLIs on that sequence, in-process: `train
   --config configs/example/waymo_train_002.yaml` (the recipe read by the
   port's YAML reader) for 300 iterations, in which the overflow watchdog
   grows the capacity, densify runs at 100 and 150 and the object loss
   starts at 160; a resume to 320; `render` (render_sets from the
   checkpoint) and `metrics`. The log must hold a finite record every 10
   iterations and the densify records, each growth must follow the
   watchdog's rule, the checkpoint must reload and re-save bit for bit
   with the run's param_checksum, the PLY must hold the alive rows, the
   four main-path kernels must launch in training (2.1 and 2.3 in
   render_sets) and agree with their plain versions on the step of
   iteration 300, render_sets must write 30 PNGs, the metrics must be
   finite and training must have raised the eval views' PSNR; then 20
   iterations of the runner on a small sequence, card against CPU.
   `[runner]`, `[render]` and `[metrics]` lines: seconds per stage,
   ms/step, the ladder, ms/view, frames per second, peak memory and the
   ground-truth cache's bytes;
10. semantics at 20 classes and normals (F = 27 blend features, past
   the 8 the kernels are instantiated for): holds kernels 2.1, 2.2, 2.5
   and 2.6 against their plain versions at F = 7, 24, 27 and 64 (random
   and long-run cases, random cotangents on every channel); renders the
   bench scene with semantics and normals, holds 2.1 and 2.2 on that
   frame's own inputs, times them at F = 4 and 27 in turns (2.5 and 2.6
   on the random table), and times views at F = 4 and 27 and at
   sky_downsample 1, 2 and 4 in turns, then a small F = 27 render card
   against CPU; trains step 8's sequence through the runner with the
   Waymo recipe and semantics and normals on for 30 iterations across
   densify_until_iter (the step after the gate held against the plain
   kernels, the PLY's 20 semantic columns), times its train step at F =
   4 and 27 on the same views in turns, runs `render --mode trajectory`
   (camera 0, sky_downsample 4, save_video false), every frame finite and
   written; LPIPS on weights from a seed at 1600x1067, card against CPU.
   `[wide]` lines;
11. tile-row bands and camera data parallel (`[parallel]` lines):
   11a serves the bench frame in 2 and 4 bands in turn against the whole
   frame (sky_downsample 1 on every row, 2 on every row but the band
   edges', where the reference's bands differ from its whole frame),
   radii equal, the overflow counters summed; kernels 2.1 and 2.3 on
   each band's own inputs, an empty band (a 32-row frame in 4 bands),
   ms/view and peak memory at D = 1, 2, 4 in turns; 11b trains the bench
   cell's step in 2 bands against the whole-frame step on the same
   draws (loss, gradients, parameters), kernels 2.2 and 2.4 on the band
   step's own inputs, ms/step at D = 1 and 2 in turns; 11c spawns two
   ranks on the one card (Gloo), one bench view each: one
   camera-parallel step in one band and in two, the ranks bit-equal and
   held to an in-process reference (both views' gradients averaged, one
   Adam step), ms/step of two ranks sharing one card (not a scaling
   figure); 11d runs `train` at train.tile_shards 2, `torchrun
   --nproc_per_node 2 ... train.batch_size 2` (rank 0 alone writes) and
   `render` with and without render.parallel tile=2 (PNGs within 1) on
   step 8's sequence;
12. Gaussian sharding and the multi-host pieces (`[gauss]` lines): 12a
   serves the bench frame through gauss=2 and gauss=4 (the table's rows
   composed in blocks in turn and joined) and gausstile=2x2 (2 blocks,
   the joined screen in 2 bands) against the whole frame: radii and the
   integer outputs equal, the images bit-equal (gausstile: the blend
   tolerances, the band-edge rows left out as in 11a); kernels 2.1 and
   2.3 on the gauss=4 render's own inputs; ms/view and peak memory in
   turns; 12b spawns two gauss ranks on the one card (Gloo), each holding
   half the bench cell's rows: the loss against the in-process single
   step's within 1e-6 relative on the same draws, every gradient leaf
   within grads_close, the radii equal, the ranks' whole states and
   replicated leaves bit-equal, each rank's row state half the whole's
   by torch.cuda.memory_allocated, the bytes each collective took,
   ms/step; the same for gauss x tile (2 bands in turn a rank); 12c runs
   `torchrun --nproc_per_node 2 ... train.gauss_shards 2` on step 8's
   sequence past a densify and a checkpoint, a resume, `render` with
   and without render.parallel gauss=2 (PNGs within 1), and two torchrun
   launches as two hosts (--nnodes 2, --master_addr 127.0.0.1) at
   train.multihost true train.batch_size 2 (each host's own views, equal
   param_checksum, one log, one checkpoint);
13. the per-pixel oracle and the demo scene (`[oracle]`, `[demo]`
   lines): 13a holds rasterize (kernels 2.1, 2.3) against the oracle
   (ops.rasterize.render_reference, plain torch, a loop over the
   depth-sorted Gaussians) on 2,000 random Gaussians at 128x192 and on a
   high-opacity scene (the early-stop path), the gradients of
   tests/test_rasterizer.py's gradient-parity loss (kernels 2.2, 2.4)
   against the oracle's autograd, and render_gaussians with shs and with
   colors_precomp against the oracle; 13b builds the demo scene
   (script.make_demo_scene: 8 frames of camera 0 at 480x320, images
   rendered from a ground-truth model) and trains it through `train
   --config configs/demo_synthetic.yaml` for its own 2,000 iterations,
   then `render` and `metrics`: every record finite, no drop (or growth
   by the watchdog's rule), the log_images grids, train_psnr at 2,000 at
   least 28 and 2 above its value at 500, beside the JAX package's
   records; 13c runs `make_ply` on the checkpoint (the vertices the rows
   visible at viewer.frame_id); 13d runs the root
   script/summarize_train_log.py on the log;
14. prints one `kernels` JSON line with all eight kernels (with the
   loaded sequence's launches before and after the gate, step 9's in
   training and in render_sets, step 10's F = 27 times, bounds,
   launches and the F = 4 times in turns with them, steps 11's and
   12's launches on the band and gauss paths, and step 13's launches
   with the oracle's errors);
15. prints {"ok": true, "device": {...}} as the last line.

Any failure raises (exit code != 0). Without CUDA, or without the rest
of the repository beside it, it fails before printing a result.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s and f32
# operations/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# kernel B against its plain version: a value agrees when
# |d| <= B_TOL * max(1, |ref|); the two differ only in the order of f32
# sums, so a pixel may disagree beyond that only where the sums flip
# which Gaussian stops it (one Gaussian of weight <= 0.99 * T, T ~ 1e-4
# / 0.01): at most B_FLIP_FRACTION of the pixels, each within B_FLIP_TOL
# * max(1, max |ref feature|)
B_TOL = 1e-5
B_FLIP_FRACTION = 1e-5
B_FLIP_TOL = 1e-2
VIEWS = 8
TRAIN_WARMUP = 3
TRAIN_STEPS = 10
# the loaded Waymo-format sequence (step 8): Waymo's FRONT resolution,
# 10 frames of 3 cameras; 25,000 LiDAR points a frame
SEQ_FRAMES = 10
SEQ_IMAGE = (1280, 1920)
SEQ_POINTS = 25_000
SEQ_CAPACITY = 1_572_864
# the Waymo recipe on that sequence: configs/experiments_waymo/_base.yaml,
# then configs/example/waymo_train_002.yaml over it (the card's machine has
# no PyYAML). Left out: source_path and selected_frames (the sequence is
# written here, 10 frames), the tracker's boxes (use_tracker: the writer
# writes only the ground-truth track file), lambda_mask and
# prune_box_interval (no term or cadence reads them), the schedules'
# lengths beyond the steps run here, and render.fps / concat_cameras.
WAYMO_RECIPE = {
    "data": {"type": "Waymo", "split_train": 1, "split_test": -1, "cameras": [0, 1, 2], "use_tracker": False,
             "extent": 10, "use_colmap": True, "white_background": False, "filter_colmap": True},
    "model": {"gaussian": {"sh_degree": 1, "fourier_dim": 5, "fourier_scale": 1.0, "flip_prob": 0.5},
              "nsg": {"include_bkgd": True, "include_obj": True, "include_sky": True, "opt_track": True}},
    "optim": {
        "densification_interval": 100, "densify_from_iter": 500, "densify_grad_threshold": 0.0002,
        "densify_until_iter": 25000, "feature_lr": 0.0025, "max_screen_size": 20, "min_opacity": 0.005,
        "opacity_lr": 0.05, "opacity_reset_interval": 3000, "percent_big_ws": 0.1, "percent_dense": 0.01,
        "position_lr_delay_mult": 0.01, "position_lr_final": 1.6e-06, "position_lr_init": 0.00016,
        "position_lr_max_steps": 50000, "rotation_lr": 0.001, "scaling_lr": 0.005, "semantic_lr": 0.01,
        "lambda_l1": 1.0, "lambda_dssim": 0.2, "lambda_reg": 0.1, "lambda_depth_lidar": 0.1,
        "lambda_sky": 0.05, "lambda_sky_scale": [1, 1, 0],
        "track_position_lr_delay_mult": 0.01, "track_position_lr_init": 0.005,
        "track_position_lr_final": 5.0e-5, "track_position_max_steps": 30000,
        "track_rotation_lr_delay_mult": 0.01, "track_rotation_lr_init": 0.001,
        "track_rotation_lr_final": 1.0e-5, "track_rotation_max_steps": 30000,
        "densify_grad_threshold_bkgd": 0.0006, "densify_grad_abs_bkgd": True,
        "densify_grad_threshold_obj": 0.0002, "densify_grad_abs_obj": False,
    },
    "render": {"tile_capacity": 0, "instance_capacity": SEQ_CAPACITY},
}
# the blend backward against its plain version: each gradient row scaled
# by its largest |plain value|. The two differ in the order of their sums
# (and the plain version's prefix sums are parallel scans on the card);
# where that order flips which Gaussian stops a pixel (B_FLIP_FRACTION
# above), the lanes of that pixel's Gaussians move by up to one pixel's
# contribution: at most BWD_FLIP_LANES of the live lanes beyond
# BWD_ATOL_SCALED, none beyond BWD_FLIP_TOL
BWD_ATOL_SCALED = 1e-4
BWD_FLIP_LANES = 1e-3
BWD_FLIP_TOL = 3e-2
# segment sums against the plain version (index_add_, atomic order on
# the card): |d| <= SEG_RTOL * (sum of the segment's |rows|), the f32
# rounding of a sum in another order
SEG_RTOL = 1e-5
# the probe's floor against its plain version: sums of a block's 1024
# values and of a run's blocks in another order, |d| <= FLOOR_RTOL * (the
# same sums of |values|)
FLOOR_RTOL = 1e-5
# iterations of the parity check's and the probe's own timing loops
PARITY_ITERS = 3
PROBE_ITERS = 10
# whole-step gradients and parameters, card against CPU: the rules of
# tests/test_torch_train.py (see grads_close and params_close)
GRAD_ATOL_SCALED = 1e-4
GRAD_ATOL_LOOSE = 1e-3
LOOSE_GRAD_ROWS = 0.03
FLIP_ROWS = 0.01


def _row_max(a):
    a = np.abs(np.asarray(a))
    return a.reshape(a.shape[0], -1).max(axis=1) if a.ndim else a.reshape(1)


def grads_close(got, want, name):
    """Gradients of a whole render: scaled by the leaf's largest |want|,
    within GRAD_ATOL_SCALED except at most LOOSE_GRAD_ROWS of the rows,
    which stay within GRAD_ATOL_LOOSE (sum orders, see
    tests/test_torch_train.py)."""
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    d = _row_max((np.asarray(got) - want) / scale)
    off = (d > GRAD_ATOL_SCALED).mean()
    if off > LOOSE_GRAD_ROWS or d.max() > GRAD_ATOL_LOOSE:
        raise AssertionError(f"{name}: {off:.2%} of rows beyond {GRAD_ATOL_SCALED}, max {d.max():.3e}")


def params_close(got, want, grad_ref, lr, steps, name):
    """Parameters after `steps` Adam steps of learning rate <= lr: rows
    whose first gradient is >= 1% of the leaf's largest within 2% of
    lr per step except at most FLIP_ROWS of them; every row within 2 lr
    per step (a gradient within noise of 0 may take either sign)."""
    d = _row_max(np.asarray(got) - np.asarray(want))
    g = _row_max(grad_ref)
    sig = g >= 0.01 * g.max()
    tight = 0.02 * lr * steps + 1e-6
    if (d[sig] > tight).mean() > FLIP_ROWS or d.max() > 2 * lr * steps + 1e-6:
        raise AssertionError(f"{name}: {(d[sig] > tight).mean():.2%} of rows beyond {tight}, max {d.max():.3e}")


def log(*args):
    print(*args, flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn() over reps calls after one warm-up call,
    by CUDA events."""
    from street_gaussians_torch._device import time_ms

    return time_ms(fn, reps, torch.device("cuda"))


def compare_blend(got: torch.Tensor, ref: torch.Tensor, F: int, what: str) -> float:
    """Kernel B output against its plain version (see B_TOL); returns
    the max abs error."""
    d = (got - ref).abs()
    scale = ref.abs().clamp(min=1.0)
    off = (d > B_TOL * scale).any(dim=-1)  # per pixel
    n_off, n_pix = int(off.sum()), off.numel()
    beyond = int((d > 1e-5).any(dim=-1).sum())
    max_err = float(d.max())
    feat_scale = max(1.0, float(ref[..., :F].abs().max()))
    log(f"[check] {what}: max_abs_err {max_err:.3e}; pixels beyond 1e-5: {beyond} of {n_pix}; "
        f"beyond the relative tolerance: {n_off}")
    if not torch.isfinite(got).all():
        raise AssertionError(f"{what}: non-finite kernel output")
    if n_off > max(1, B_FLIP_FRACTION * n_pix) or max_err > B_FLIP_TOL * feat_scale:
        raise AssertionError(f"{what}: kernel disagrees with its plain version")
    return max_err


def compare_blend_bwd(got: torch.Tensor, ref: torch.Tensor, live: torch.Tensor, F: int, what: str) -> float:
    """The blend backward against its plain version (see BWD_ATOL_SCALED);
    returns the max abs error."""
    if not torch.isfinite(got).all():
        raise AssertionError(f"{what}: non-finite kernel output")
    rows = 6 + F + 2
    g = got[:, :rows].transpose(0, 1).reshape(rows, -1)[:, live]
    r = ref[:, :rows].transpose(0, 1).reshape(rows, -1)[:, live]
    d = (g - r).abs() / r.abs().amax(dim=1, keepdim=True).clamp(min=1e-30)
    off = int((d > BWD_ATOL_SCALED).any(dim=0).sum())
    n = int(live.sum())
    max_err = float((got - ref).abs().max())
    log(f"[check] {what}: max_abs_err {max_err:.3e}; max scaled err {float(d.max()):.3e}; "
        f"lanes beyond {BWD_ATOL_SCALED} scaled: {off} of {n}")
    if off > max(1, BWD_FLIP_LANES * n) or float(d.max()) > BWD_FLIP_TOL:
        raise AssertionError(f"{what}: backward kernel disagrees with its plain version")
    if (got[:, rows:] != 0).any() or (got.transpose(0, 1).reshape(got.shape[1], -1)[:, ~live] != 0).any():
        raise AssertionError(f"{what}: backward kernel wrote outside the live lanes")
    return max_err


def live_lanes(payload, tile_start, tile_count) -> torch.Tensor:
    """[NB+1 x 128] bool: the slots some tile's run covers."""
    n = payload.shape[0] * 128
    delta = torch.zeros(n + 1, dtype=torch.int32, device=payload.device)
    s = tile_start.long()
    e = s + tile_count.long()
    delta.index_add_(0, s, torch.ones_like(tile_start))
    delta.index_add_(0, e, -torch.ones_like(tile_start))
    return torch.cumsum(delta, 0)[:n] > 0


def compare_segsum(got, ref, abs_sum, what: str) -> float:
    """Segment sums against the plain version (see SEG_RTOL)."""
    d = (got - ref).abs()
    bad = int((d > SEG_RTOL * abs_sum + 1e-30).sum())
    max_err = float(d.max())
    log(f"[check] {what}: max_abs_err {max_err:.3e}; sums beyond {SEG_RTOL} x sum|rows|: {bad} of {d.numel()}")
    if bad or not torch.isfinite(got).all():
        raise AssertionError(f"{what}: segment_rowsum kernel disagrees with its plain version")
    return max_err


def check_emulated(got, d, keys, num_segments, what: str) -> None:
    """The identity-segment kernel against its order of sums emulated on
    the CPU (ops.segsum.segment_rowsum_emulated): bit for bit."""
    from street_gaussians_torch.ops import segsum

    want = segsum.segment_rowsum_emulated(d.cpu(), keys.cpu(), num_segments=num_segments)
    if not torch.equal(got.cpu(), want):
        n = int((got.cpu() != want).sum())
        raise AssertionError(f"{what}: {n} sums differ from the kernel's order emulated on the CPU")
    log(f"[check] {what}: bit-equal to the kernel's order emulated on the CPU")


def compare_floor(got, ref, abs_ref, what: str) -> float:
    """The probe's floor against its plain version (see FLOOR_RTOL)."""
    d = (got - ref).abs()
    bad = int((d > FLOOR_RTOL * abs_ref + 1e-30).sum())
    max_err = float(d.max())
    log(f"[check] {what}: max_abs_err {max_err:.3e} (largest |sum| {float(ref.abs().max()):.3e}); "
        f"values beyond {FLOOR_RTOL} x sum|values|: {bad} of {d.numel()}")
    if bad or not torch.isfinite(got).all():
        raise AssertionError(f"{what}: probe_floor kernel disagrees with its plain version")
    return max_err


def run_blocks(tile_start, tile_count, num_blocks: int) -> int:
    """How many distinct payload blocks the tiles' runs touch."""
    s = tile_start.long() // 128
    nb = torch.where(tile_count > 0, (tile_start.long() % 128 + tile_count.long() + 127) // 128, 0)
    delta = torch.zeros(num_blocks + 1, dtype=torch.int64, device=tile_start.device)
    delta.index_add_(0, s, (nb > 0).long())
    delta.index_add_(0, s + nb, -(nb > 0).long())
    return int((torch.cumsum(delta, 0)[:num_blocks] > 0).sum())


def random_expand_case(seed: int, N: int, dev):
    rng = np.random.default_rng(seed)
    cnt = rng.integers(0, 9, N).astype(np.int32)
    cnt[rng.uniform(size=N) < 0.3] = 0
    offs = (np.cumsum(cnt) - cnt).astype(np.int32)
    total = int(offs[-1] + cnt[-1])
    vals = np.stack([rng.integers(0, 1 << 22, N).astype(np.float32),
                     rng.normal(size=N).astype(np.float32) * 1e3,
                     rng.normal(size=N).astype(np.float32)])
    t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    return t(vals), t(offs), torch.tensor(total, dtype=torch.int32, device=dev), total + 4097


def random_blend_case(seed: int, dev, grid_x=40, grid_y=30, F=4, max_count=700, opacity_hi=0.99,
                      opacity_lo=0.02, counts=None):
    """Ragged runs of random screen-space Gaussians (about a fifth of the
    tiles empty unless `counts` gives every tile's run length, the first
    run not block-aligned, features: rgb in [0, 1) then depths in
    [1, 50)). Returns tile_blend_instances' args."""
    from street_gaussians_torch.ops.tile_raster2 import payload_rows

    rng = np.random.default_rng(seed)
    T = grid_x * grid_y
    if counts is None:
        counts = rng.integers(0, max_count, T)
        counts[rng.uniform(size=T) < 0.2] = 0
    counts = np.asarray(counts, np.int32)
    lead = 37  # dead rows before the first run
    starts = (lead + np.cumsum(counts) - counts).astype(np.int32)
    S = lead + int(counts.sum())
    nb = -(-S // 128)
    rows = np.zeros((nb * 128, payload_rows(F)), np.float32)
    tile = np.repeat(np.arange(T), counts)
    sl = slice(lead, S)
    n = S - lead
    rows[sl, 0] = (tile % grid_x) * 16 + rng.uniform(-8, 24, n)
    rows[sl, 1] = (tile // grid_x) * 16 + rng.uniform(-8, 24, n)
    rows[sl, 2] = rng.uniform(0.01, 0.3, n)
    rows[sl, 3] = rng.uniform(-0.05, 0.05, n)
    rows[sl, 4] = rng.uniform(0.01, 0.3, n)
    rows[sl, 5] = rng.uniform(opacity_lo, opacity_hi, n)
    rows[sl, 6:5 + F] = rng.uniform(0, 1, (n, F - 1))
    rows[sl, 5 + F] = rng.uniform(1, 50, n)
    payload = np.concatenate(
        [rows.reshape(nb, 128, -1).transpose(0, 2, 1), np.zeros((1, rows.shape[1], 128), np.float32)]
    )
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=dev)  # noqa: E731
    return t(payload), t(starts), t(counts), F, grid_x, T


# run lengths of the long-run case: several times SEG (1,024), one lane
# short of, at and one past multiples of it, short and empty runs between
LONG_RUNS = (12_000, 0, 300, 10_500, 1_025, 1_024, 2_048, 5_000, 37, 0, 2_065, 640, 1_023, 1_537, 16_900, 91)
# its opacity ranges: pixels that stop within the first segment, in a
# later one, and never
LONG_OPACITIES = ((0.02, 0.99), (0.02, 0.05), (0.004, 0.008))


def long_blend_case(seed: int, dev, opacity, F: int = 4):
    """random_blend_case with LONG_RUNS on a 4x4 grid."""
    return random_blend_case(seed, dev, grid_x=4, grid_y=4, F=F, counts=LONG_RUNS,
                             opacity_lo=opacity[0], opacity_hi=opacity[1])


def random_table_case(seed: int, dev, grid_x=40, grid_y=30, F=4, K=768, counts=None, opacity_hi=0.99):
    """A dense table of random screen-space Gaussians (about a fifth of
    the tiles empty unless `counts` is given; features: rgb in [0, 1)
    then depths in [1, 50)). Slots at and beyond a tile's count have
    opacity 0 and garbage in every other row, which the blend must
    ignore. Returns tile_raster.tile_blend's args."""
    from street_gaussians_torch.ops.tile_raster2 import payload_rows

    rng = np.random.default_rng(seed)
    T = grid_x * grid_y
    if counts is None:
        counts = rng.integers(0, K + 1, T)
        counts[rng.uniform(size=T) < 0.2] = 0
    counts = np.asarray(counts, np.int32)
    tile = np.arange(T)[:, None]
    table = np.zeros((T, payload_rows(F), K), np.float32)
    table[:, 0] = (tile % grid_x) * 16 + rng.uniform(-8, 24, (T, K))
    table[:, 1] = (tile // grid_x) * 16 + rng.uniform(-8, 24, (T, K))
    table[:, 2] = rng.uniform(0.01, 0.3, (T, K))
    table[:, 3] = rng.uniform(-0.05, 0.05, (T, K))
    table[:, 4] = rng.uniform(0.01, 0.3, (T, K))
    table[:, 5] = rng.uniform(0.02, opacity_hi, (T, K))
    table[:, 6:5 + F] = rng.uniform(0, 1, (T, F - 1, K))
    table[:, 5 + F] = rng.uniform(1, 50, (T, K))
    empty = np.arange(K)[None, :] >= counts[:, None]
    garbage = rng.normal(size=table.shape).astype(np.float32) * 100.0
    table = np.where(empty[:, None, :], garbage, table)
    table[:, 5][empty] = 0.0
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=dev)  # noqa: E731
    return t(table), t(counts), F, grid_x


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from street_gaussians_torch import serve
    from street_gaussians_torch.kernels import _build
    from street_gaussians_torch.models.renderer import screen_space
    from street_gaussians_torch.models.sky_cubemap import build_sky_table
    from street_gaussians_torch.ops import binning, fill, rasterize, tile_raster2
    from street_gaussians_torch.script import block_times, search_times

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    log(smi)
    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    # ---- 2. build ----
    t0 = time.perf_counter()
    with ThreadPoolExecutor(3) as pool:
        probe_build = pool.submit(_build.build, block_times.REGIONS, block_times.PROBE_FLAGS)
        search_build = pool.submit(_build.build, search_times.SOURCES, search_times.PROBE_FLAGS)
        built = _build.build(_build.ALL_SOURCES)
        probe_build.result()
        search_build.result()
    log(f"[build] {time.perf_counter() - t0:.2f} s wall for the {len(_build.ALL_SOURCES)} sources (8 kernels) "
        f"and the probe builds of {list(block_times.REGIONS)} and {list(search_times.SOURCES)}")
    for name, info in built.items():
        ptxas = [ln.strip() for ln in info["log"].splitlines() if "registers" in ln or "Compiling" in ln]
        log(f"[build] {name}.cu {info['seconds']:.2f} s; " + " | ".join(ptxas))

    # ---- 3a. random cases ----
    v, o, tot, S = random_expand_case(0, 200_000, dev)
    if not torch.equal(fill.expand_runs(v, o, tot, S), fill.expand_runs_plain(v, o, tot, S)):
        raise AssertionError("expand_runs kernel != plain on the random case")
    torch.cuda.synchronize()
    log(f"[check] expand_runs random ragged (C=3, N=200000, S={S}): exact")
    case = random_blend_case(1, dev)
    err_b = compare_blend(
        tile_raster2.tile_blend_instances(*case), tile_raster2.tile_blend_plain(*case),
        case[3], "tile_blend random ragged (1200 tiles)",
    )
    for opacity in LONG_OPACITIES:
        case = long_blend_case(1, dev, opacity)
        err_b = max(err_b, compare_blend(
            tile_raster2.tile_blend_instances(*case), tile_raster2.tile_blend_plain(*case), case[3],
            f"tile_blend long runs (16 tiles, up to {max(LONG_RUNS)} lanes, opacity {opacity})"))

    # ---- 3b. the bench frame's own inputs ----
    t0 = time.perf_counter()
    scene, params = serve.bench_scene(seed=0, device=dev)
    torch.cuda.synchronize()
    log(f"[scene] capacity {scene.table.capacity} rows, {len(scene.frames)} frames, "
        f"built in {time.perf_counter() - t0:.2f} s")
    if scene.table.capacity != 661_248:
        raise AssertionError(f"bench scene capacity {scene.table.capacity} != 661248")
    opts = serve.SERVE_OPTS
    frame = scene.frames[0]
    H, W = frame.cam.H, frame.cam.W
    with torch.no_grad():
        screen, _ = screen_space(params, scene.aux, scene.table, scene.pose_data, frame,
                                 serve.SERVE_STEP, opts=opts)
        gx, gy = (W + 15) // 16, (H + 15) // 16
        ex = binning.expand_inputs(screen, gx, gy, corner_cull=opts.corner_cull)
        S = opts.instance_capacity
        a_out = fill.expand_runs(ex.vals, ex.offs, ex.total, S)
        err_a = float((a_out - fill.expand_runs_plain(ex.vals, ex.offs, ex.total, S)).abs().max())
        if err_a != 0.0:
            raise AssertionError(f"expand_runs kernel != plain on the bench frame ({err_a})")
        C, N = ex.vals.shape
        total = int(ex.total)
        log(f"[check] expand_runs bench frame (C={C}, N={N}, S={S}, total={total}): exact")
        cfg = rasterize.RasterizeConfig(opts.tile_capacity, opts.instance_capacity,
                                        corner_cull=opts.corner_cull)
        bi = rasterize.blend_inputs(screen, H, W, config=cfg)
        F, T = bi.num_features, gx * gy
        b_args = (bi.payload, bi.bins.tile_start, bi.bins.tile_count, F, gx, T)
        b_out = tile_raster2.tile_blend_instances(*b_args)
        b_ref, work = tile_raster2.tile_blend_plain(*b_args, return_work=True)
        err_b = max(err_b, compare_blend(b_out, b_ref, F, f"tile_blend bench frame ({T} tiles)"))
        seg_blocks = tile_raster2.SEG // tile_raster2.CHUNK
        plan = tile_raster2.blend_plan(bi.bins.tile_start, bi.bins.tile_count, bi.payload.shape[0], seg_blocks)
        plan_ref = tile_raster2.blend_plan_plain(bi.bins.tile_start, bi.bins.tile_count, seg_blocks)
        if ((plan["n_long"], plan["n_items"]) != (plan_ref["n_long"], plan_ref["n_items"])
                or any(not torch.equal(plan[k], plan_ref[k]) for k in ("tile_slot", "item_tile", "item_seg"))):
            raise AssertionError("the blend's work list differs from its plain version on the bench frame")
        log(f"[check] blend work list bench frame (SEG={tile_raster2.SEG}): exact; {plan['n_items']} items, "
            f"{plan['n_long']} of them segments of {int((plan['tile_slot'] >= 0).sum())} long tiles")
        log(f"[runs] bench frame: {json.dumps(block_times.run_length_stats(bi.bins.tile_count))}")
        for row in block_times.block_times("tile_blend", lambda: tile_raster2.tile_blend_instances(*b_args), F):
            log(f"[blocks] forward, bench frame: {json.dumps(row)}")
        live = int(bi.bins.tile_count.sum())
        evaluated, blended = int(work["evaluated"]), int(work["blended"])
        log(f"[check] bench frame: {int(bi.bins.num_instances)} instances, {live} kept, "
            f"{evaluated} pixel-instance pairs evaluated, {blended} blended")

        # ---- 3c. the whole path on a small input: kernels vs plain (CPU) ----
        small = {}
        for d in (dev, torch.device("cpu")):
            sc, pr = serve.bench_scene(seed=3, device=d, sky_resolution=16,
                                       num_bkgd=600, num_actors=2, H=64, W=96)
            small[d.type] = serve.render_views(
                sc, pr, sc.frames[5:6], serve.SERVE_OPTS, device=d)[0]
        for k in ("rgb", "depth", "acc", "T"):
            err = float((small["cuda"][k].cpu() - small["cpu"][k]).abs().max())
            if not err <= 1e-4:
                raise AssertionError(f"small render {k}: card vs CPU max abs err {err}")
        log("[check] small render (64x96, 2 actors, sky): card path within 1e-4 of the CPU path")

    # ---- 4. serve: counters from 0 just before the timed views ----
    with torch.no_grad():
        sky_table = build_sky_table(params.sky.cubemap)
    serve.render_views(scene, params, scene.frames[:1], opts, device=dev, sky_table=sky_table)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    fill.expand_runs.launches = 0
    tile_raster2.tile_blend_instances.launches = 0
    view_ms = []
    outs = []
    for i in range(VIEWS):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        (out,) = serve.render_views(scene, params, [scene.frames[i % len(scene.frames)]], opts,
                                    device=dev, sky_table=sky_table)
        e1.record()
        outs.append(out)
        torch.cuda.synchronize()
        view_ms.append(e0.elapsed_time(e1))
    launches = {"expand_runs": fill.expand_runs.launches,
                "tile_blend_instances": tile_raster2.tile_blend_instances.launches}
    serve_launches = dict(launches)
    peak = torch.cuda.max_memory_allocated(dev)
    for i, out in enumerate(outs):
        for k in ("rgb", "depth", "acc", "T"):
            if not torch.isfinite(out[k]).all():
                raise AssertionError(f"view {i}: non-finite {k}")
        if tuple(out["rgb"].shape) != (H, W, 3):
            raise AssertionError(f"view {i}: rgb shape {tuple(out['rgb'].shape)}")
        if int(out["overflow"]) != 0:
            raise AssertionError(f"view {i}: overflow {int(out['overflow'])}")
        log(f"[serve] view {i}: {view_ms[i]:.3f} ms, {int(out['num_instances'])} instances, "
            f"mean rgb {float(out['rgb'].mean()):.4f}, acc {float(out['acc'].mean()):.4f}")
    if launches["tile_blend_instances"] != VIEWS or launches["expand_runs"] < VIEWS:
        raise AssertionError(f"main path launches {launches} for {VIEWS} views")
    log(f"[serve] {VIEWS} views: mean {sum(view_ms) / VIEWS:.3f} ms/view "
        f"(min {min(view_ms):.3f}, max {max(view_ms):.3f}); peak memory {peak / 2**30:.3f} GiB; "
        f"launches {launches}")

    # ---- 5. train ----
    del outs, small
    torch.cuda.empty_cache()
    t = train_phase(dev)

    # ---- 6. kernel times, plain times, yardstick, bounds ----
    with torch.no_grad():
        ends = torch.cat([ex.offs[1:], ex.total.reshape(1)])
        cnt = ends - ex.offs
        lib_out = lambda: torch.nn.functional.pad(  # noqa: E731
            torch.repeat_interleave(ex.vals, cnt, dim=1, output_size=total), (0, S - total))
        if not torch.equal(lib_out(), a_out):
            raise AssertionError("repeat_interleave yardstick != expand_runs")
        a_ms = cuda_ms(lambda: fill.expand_runs(ex.vals, ex.offs, ex.total, S), 50)
        a_search = search_only_ms(lambda: fill.expand_runs(ex.vals, ex.offs, ex.total, S), 50)
        log(f"[probe] expand_runs bench frame: whole {a_ms:.4f} ms, search only {a_search:.4f} ms")
        a_plain = cuda_ms(lambda: fill.expand_runs_plain(ex.vals, ex.offs, ex.total, S), 20)
        a_lib = cuda_ms(lib_out, 20)
        b_ms = cuda_ms(lambda: tile_raster2.tile_blend_instances(*b_args), 20)
        b_plain = cuda_ms(lambda: tile_raster2.tile_blend_plain(*b_args), 2)
    a_bytes = 4 * (C * N + N + 1 + C * S)
    a_ops = S * math.ceil(math.log2(N + 1))  # one compare per search step
    b_bytes = 4 * (live * (6 + F) + T * 256 * (F + 1) + 2 * T)
    # f32 operations (exp / log1p counted as one): 17 for every pair a
    # pixel evaluates, 9 + 2F more for every pair it blends
    b_ops = 17 * evaluated + (9 + 2 * F) * blended

    # ---- 7. the dense-table layout and the probe ----
    table_kernels = table_phase(dev, screen, H, W, b_args, b_ref, b_plain, bound(b_bytes, b_ops))

    # ---- 8. a Waymo-format sequence from disk, trained across the gate;
    # 9. the same sequence through the three CLIs ----
    del screen, b_args, b_ref
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="sg_waymo_")
    try:
        seq = waymo_phase(dev, tmp)
        torch.cuda.empty_cache()
        run = runner_phase(dev, os.path.join(tmp, "seq"), tmp, smi)
        torch.cuda.empty_cache()
        wide = wide_phase(dev, os.path.join(tmp, "seq"), tmp, smi)
        torch.cuda.empty_cache()
        # ---- 11. tile-row bands and camera data parallel ----
        par = parallel_phase(dev, scene, params, os.path.join(tmp, "seq"), tmp, smi)
        torch.cuda.empty_cache()
        # ---- 12. Gaussian-sharded rendering and training, multi-host ----
        gs = gauss_phase(dev, scene, params, os.path.join(tmp, "seq"), tmp, smi)
        torch.cuda.empty_cache()
        # ---- 13. the per-pixel oracle, the demo scene's convergence, make_ply ----
        s13 = step13_phase(dev, tmp, smi)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    kernels = []
    train = {"path": f"{TRAIN_STEPS} train steps"}
    for name, src, rep, n, err, ms, plain, lib, (bms, by), extra in (
        ("expand_runs", "street_gaussians_torch/csrc/fill.cu",
         "street_gaussians_tpu/ops/fill.py:55", t["launches"]["expand_runs"], err_a,
         a_ms, a_plain, a_lib, bound(a_bytes, a_ops),
         {**train, "serve_launches": serve_launches["expand_runs"], "search_only_ms": a_search}),
        ("tile_blend_instances", "street_gaussians_torch/csrc/tile_blend.cu",
         "street_gaussians_tpu/ops/tile_raster2.py:318", t["launches"]["tile_blend_instances"], err_b,
         b_ms, b_plain, None, bound(b_bytes, b_ops),
         {**train, "serve_launches": serve_launches["tile_blend_instances"]}),
        *((*k[:-1], {**train, **k[-1]}) for k in t["kernels"]),
        *table_kernels,
    ):
        if "train" in extra["path"]:
            extra = {**extra, "launches_per_step": n / TRAIN_STEPS}
        if name in seq["errors"]:
            err = max(err, seq["errors"][name], run["errors"][name])
        if name in run["launches"]:
            extra = {**extra, "runner_launches": run["launches"][name]}
        if name in seq["launches"]:
            extra = {**extra, "waymo_launches": seq["launches"][name],
                     "waymo_launches_per_step": {k: v / TRAIN_STEPS for k, v in seq["launches"][name].items()}}
        if name in wide["errors"]:
            err = max(err, wide["errors"][name])
        if name in wide["f27"]:
            extra = {**extra, f"f{WIDE_F}": wide["f27"][name]}
        if name in par["errors"]:
            err = max(err, par["errors"][name])
        band_launches = {k: v[name] for k, v in par["launches"].items() if name in v}
        band_launches.update({f"serve_{k}": v[name] for k, v in par["launches"]["serve"].items() if name in v})
        if band_launches:
            extra = {**extra, "band_launches": band_launches}
        if name in gs["errors"]:
            err = max(err, gs["errors"][name])
        gauss_launches = {f"serve_{k}": v[name] for k, v in gs["launches"]["serve"].items() if name in v}
        gauss_launches.update({k: v[name] for k, v in gs["launches"].items() if k != "serve" and name in v})
        if gauss_launches:
            extra = {**extra, "gauss_launches": gauss_launches}
        step13_launches = {k: v[name] for k, v in s13["launches"].items() if name in v}
        if step13_launches:
            oracle = s13["oracle_errors"]
            if name in ("expand_runs", "tile_blend_instances"):
                oracle_err = max(v for k, v in oracle.items() if k != "gradients_scaled")
            else:
                oracle_err = oracle["gradients_scaled"]
            extra = {**extra, "step13_launches": step13_launches, "oracle_err": oracle_err}
        kernels.append({"name": name, "route": "cuda", "source": src, "replaces": rep,
                        "launches": n, "max_abs_err": err, "ms": ms, "kernel_ms": ms,
                        "plain_ms": plain, "bound_ms": bms, "bound_by": by, "library_ms": lib, **extra})
        log(f"[kernel] {name}: {ms:.4f} ms (plain {plain:.4f} ms, library "
            f"{'n/a' if lib is None else f'{lib:.4f} ms'}), bound {bms:.4f} ms by {by}; "
            f"{n} launches in {extra['path']}")
    log(f"[kernel] bench-frame counts: expand_runs bytes {a_bytes}, compares {a_ops}; "
        f"tile_blend bytes {b_bytes}, f32 ops {b_ops}")

    log(f"[waymo] summary: {json.dumps({k: v for k, v in seq.items() if k not in ('launches', 'errors')})}")
    log(f"[runner] summary: {json.dumps({k: v for k, v in run.items() if k not in ('launches', 'errors')})}")
    log(f"[wide] summary: {json.dumps(wide['numbers'])}")
    log(f"[parallel] summary: {json.dumps(par['numbers'])}")
    log(f"[gauss] summary: {json.dumps(gs['numbers'])}")
    log(f"[demo] summary: {json.dumps(s13['numbers'])}")
    log(smi)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


def table_phase(dev, screen, H, W, b_args, b_ref, b_plain, b_bound) -> list:
    """Step 7. `screen`, `b_args` (tile_blend_instances' arguments),
    `b_ref` (its plain output), `b_plain` (the plain version's ms) and
    `b_bound` are the bench frame's, from steps 3b and 6. Returns the
    four new kernels' entries for the `kernels` line."""
    from street_gaussians_torch.ops import rasterize, segsum, tile_raster, tile_raster2
    from street_gaussians_torch.script import parity_check, probe_kernel

    # ---- 7a. random cases ----
    case = random_table_case(2, dev)
    payload, counts, F, gx = case
    T, K = payload.shape[0], payload.shape[2]
    out = tile_raster.tile_blend(*case)
    err_tf = compare_blend(out, tile_raster.tile_blend_plain(*case), F,
                           f"table blend random ({T} tiles, K={K})")
    gen = torch.Generator().manual_seed(13)
    gout = torch.randn((T, 256, F + 1), generator=gen).to(dev)
    live = (torch.arange(K, device=dev)[None, :] < counts[:, None]).reshape(-1)
    err_tb = compare_blend_bwd(
        tile_raster.tile_blend_bwd(payload, counts, out, gout, F, gx),
        tile_raster.tile_blend_bwd_plain(payload, counts, out, gout, F, gx),
        live, F, f"table blend backward random ({T} tiles, K={K})")
    rcase = random_blend_case(1, dev)
    err_floor = compare_floor(
        probe_kernel.probe_floor(*rcase), probe_kernel.probe_floor_plain(*rcase),
        probe_kernel.probe_floor_plain(rcase[0].abs(), *rcase[1:]), "probe_floor random ragged (1200 tiles)")
    err_mma = compare_blend(probe_kernel.probe_blend_mma(*rcase), tile_raster2.tile_blend_plain(*rcase),
                            rcase[3], "probe_blend_mma random ragged (1200 tiles)")
    del case, payload, out, gout, rcase

    # ---- 7b. the bench frame's own inputs ----
    icap = 2**21
    with torch.no_grad():
        max_count = parity_check.largest_tile_count(screen, H, W, icap)
        K = max(1024, -(-max_count // 128) * 128)
        bi = rasterize.blend_inputs(
            screen, H, W, config=rasterize.RasterizeConfig(K, icap, layout="table"))
        if int(bi.bins.overflow) != 0:
            raise AssertionError(f"bench table: {int(bi.bins.overflow)} instances dropped at K={K}")
        F, gx, T = bi.num_features, bi.grid_x, bi.grid_x * bi.grid_y
        t_args = (bi.payload, bi.bins.tile_count, F, gx)
        t_out = tile_raster.tile_blend(*t_args)
        t_ref, work = tile_raster.tile_blend_plain(*t_args, return_work=True)
        err_tf = max(err_tf, compare_blend(t_out, t_ref, F, f"table blend bench frame ({T} tiles, K={K})"))
        del t_ref
        gen = torch.Generator(device=dev).manual_seed(14)
        gout = torch.randn((T, 256, F + 1), generator=gen, device=dev)
        bwd_args = (bi.payload, bi.bins.tile_count, t_out, gout, F, gx)
        live = (torch.arange(K, device=dev)[None, :] < bi.bins.tile_count[:, None]).reshape(-1)
        err_tb = max(err_tb, compare_blend_bwd(
            tile_raster.tile_blend_bwd(*bwd_args), tile_raster.tile_blend_bwd_plain(*bwd_args),
            live, F, f"table blend backward bench frame ({T} tiles, K={K})"))
        n_live, evaluated, blended = int(live.sum()), int(work["evaluated"]), int(work["blended"])
        log(f"[check] bench table: largest tile {max_count}, K={K}, {n_live} live slots, "
            f"{int(work['chunks'])} chunks read, {evaluated} pixel-slot pairs evaluated, {blended} blended")
        tf_ms = cuda_ms(lambda: tile_raster.tile_blend(*t_args), 20)
        tf_plain = cuda_ms(lambda: tile_raster.tile_blend_plain(*t_args), 1)
        tb_ms = cuda_ms(lambda: tile_raster.tile_blend_bwd(*bwd_args), 10)
        tb_plain = cuda_ms(lambda: tile_raster.tile_blend_bwd_plain(*bwd_args), 1)
        # f32 operations (exp counted as one): 17 for every pair a pixel
        # evaluates, as the instance blend; 6 + 2F more for a pair it
        # blends (no log1p in the product form); the backward adds the
        # gradient terms (30 + 3F) and the pair's share of the 256-pixel
        # sums (8 + F)
        tf_bound = bound(4 * (n_live * (6 + F) + T * 256 * (F + 1) + T),
                         17 * evaluated + (6 + 2 * F) * blended)
        tb_bound = bound(4 * (n_live * (6 + F) + 2 * T * 256 * (F + 1) + T + bi.payload.numel()),
                         17 * evaluated + (44 + 6 * F) * blended)
        del bi, t_args, t_out, gout, bwd_args, live

        floor_out = probe_kernel.probe_floor(*b_args)
        err_floor = max(err_floor, compare_floor(
            floor_out, probe_kernel.probe_floor_plain(*b_args),
            probe_kernel.probe_floor_plain(b_args[0].abs(), *b_args[1:]), "probe_floor bench frame"))
        mma_out = probe_kernel.probe_blend_mma(*b_args)
        err_mma = max(err_mma, compare_blend(mma_out, b_ref, b_args[3], "probe_blend_mma bench frame"))
        compare_blend(mma_out, tile_raster2.tile_blend_instances(*b_args), b_args[3],
                      "probe variant against the current kernel, bench frame")
        del floor_out, mma_out
        floor_ms = cuda_ms(lambda: probe_kernel.probe_floor(*b_args), 20)
        floor_plain = cuda_ms(lambda: probe_kernel.probe_floor_plain(*b_args), 5)
        mma_ms = cuda_ms(lambda: probe_kernel.probe_blend_mma(*b_args), 10)
        blocks = run_blocks(b_args[1], b_args[2], b_args[0].shape[0])
        T, F = b_args[5], b_args[3]
        floor_bound = bound(4 * (blocks * 8 * 128 + T * 256 * (F + 1) + 2 * T), 0)
    torch.cuda.empty_cache()

    # ---- 7c. the table path: parity with the instance layout ----
    counters = {"tile_blend_table": tile_raster.tile_blend, "tile_blend_table_bwd": tile_raster.tile_blend_bwd,
                "segment_rowsum": segsum.segment_rowsum,
                "tile_blend_instances": tile_raster2.tile_blend_instances,
                "tile_blend_bwd": tile_raster2.tile_blend_bwd}
    for k in counters.values():
        k.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    res = parity_check.compare_layouts(screen, H, W, 1024, icap, iters=PARITY_ITERS, log=log)
    launches = {name: k.launches for name, k in counters.items()}
    res["peak_memory_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
    # per layout: forward 2 + PARITY_ITERS, forward + backward 1 + (1 + PARITY_ITERS)
    if (launches["tile_blend_table"] != 2 * PARITY_ITERS + 4 or launches["tile_blend_table_bwd"] != PARITY_ITERS + 2
            or launches["segment_rowsum"] != 2 * (PARITY_ITERS + 2)):
        raise AssertionError(f"table parity path launches {launches}")
    log(f"[parity] bench frame {W}x{H}: {json.dumps(res)}; launches {launches}")
    torch.cuda.empty_cache()
    own = parity_check.parity_check(device=dev, iters=PARITY_ITERS, log=log)
    log(f"[parity] the check's own scene 1280x880: {json.dumps(own)}")
    torch.cuda.empty_cache()

    # ---- 7d. the probe ----
    probe_kernel.probe_floor.launches = probe_kernel.probe_blend_mma.launches = 0
    probe = probe_kernel.run_probe(*b_args, iters=PROBE_ITERS, log=log)
    probe_launches = {"probe_floor": probe_kernel.probe_floor.launches,
                      "probe_blend_mma": probe_kernel.probe_blend_mma.launches}
    if probe_launches["probe_floor"] != PROBE_ITERS + 1 or probe_launches["probe_blend_mma"] != PROBE_ITERS + 2:
        raise AssertionError(f"probe path launches {probe_launches}")
    log(f"[probe] bench frame: {json.dumps(probe)}; launches {probe_launches}")

    parity = {"path": "the table parity check", "parity_fwd_ms": res["fwd_ms"],
              "parity_fwd_bwd_ms": res["fwd_bwd_ms"], "tile_capacity": res["tile_capacity"]}
    in_probe = {"path": "the probe", "probe_ms": probe}
    return [
        ("tile_blend_table", "street_gaussians_torch/csrc/tile_blend_table.cu",
         "street_gaussians_tpu/ops/tile_raster.py:167", launches["tile_blend_table"], err_tf,
         tf_ms, tf_plain, None, tf_bound, parity),
        ("tile_blend_table_bwd", "street_gaussians_torch/csrc/tile_blend_table_bwd.cu",
         "street_gaussians_tpu/ops/tile_raster.py:214", launches["tile_blend_table_bwd"], err_tb,
         tb_ms, tb_plain, None, tb_bound, parity),
        ("probe_floor", "street_gaussians_torch/csrc/probe_blend.cu",
         "script/probe_kernel.py:60", probe_launches["probe_floor"], err_floor,
         floor_ms, floor_plain, None, floor_bound, in_probe),
        ("probe_blend_mma", "street_gaussians_torch/csrc/probe_blend.cu",
         "script/probe_kernel.py:82", probe_launches["probe_blend_mma"], err_mma,
         mma_ms, b_plain, None, b_bound, in_probe),
    ]


def merge_config(cfg, overrides: dict):
    """cfg with the nested dict `overrides` written over it."""
    for k, v in overrides.items():
        if isinstance(v, dict):
            merge_config(cfg[k], v)
        else:
            cfg[k] = v
    return cfg


def waymo_phase(dev, tmp: str) -> dict:
    """Step 8: write a Waymo-format sequence at Waymo's resolution under
    tmp/seq (step 9 reads it again), load it with the port's loaders, and
    train it with the Waymo recipe (the object-opacity loss on) on both
    sides of densify_until_iter; then two small train steps across that
    gate, card against CPU. Returns the main-path kernels' launches before
    and after the gate, their largest errors on the gate step's inputs,
    the times and the sequence's root."""
    import copy
    import dataclasses
    import os

    from street_gaussians_torch import native, serve
    from street_gaussians_torch.config import default_config
    from street_gaussians_torch.data import waymo
    from street_gaussians_torch.data.dataset import _resize_shape, load_ground_truth, load_waymo_scene
    from street_gaussians_torch.data.synthetic_waymo import write_synthetic_waymo
    from street_gaussians_torch.models import sky_cubemap
    from street_gaussians_torch.ops import fill, rasterize, segsum, tile_raster2
    from street_gaussians_torch.runner import build_initial_params, render_opts_from_cfg
    from street_gaussians_torch.train_lib import Draws, flatten_params, init_train_state, make_train_step

    kernels = (fill.expand_runs, tile_raster2.tile_blend_instances, tile_raster2.tile_blend_bwd,
               segsum.segment_rowsum)
    root = os.path.join(tmp, "seq")
    # ---- 8a. write ----
    t0 = time.perf_counter()
    write_synthetic_waymo(root, num_frames=SEQ_FRAMES, cameras=(0, 1, 2), image_size=SEQ_IMAGE,
                          points_per_frame=SEQ_POINTS, seed=0, actor_in_view=True)
    t_write = time.perf_counter() - t0
    nbytes = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(root) for f in fs)
    log(f"[waymo] wrote {SEQ_FRAMES} frames x 5 sensors at {SEQ_IMAGE[1]}x{SEQ_IMAGE[0]}, "
        f"{SEQ_POINTS} LiDAR points a frame: {nbytes / 2**20:.1f} MiB in {t_write:.2f} s")

    # ---- 8b. load, once, its stages timed where the loader calls them ----
    cfg = merge_config(default_config(), copy.deepcopy(WAYMO_RECIPE))
    cfg.source_path, cfg.model_path, cfg.mode = root, os.path.join(tmp, "out"), "train"
    lib = native.load_native() is not None
    stages = {"parse": CallRecorder(waymo.generate_dataparser_outputs, [waymo]),
              "clouds": CallRecorder(waymo._build_pointclouds, [waymo]),
              "png": CallRecorder(waymo.imread, [waymo])}
    t0 = time.perf_counter()
    np.random.seed(0)  # the actor's grid colours
    try:
        scene = load_waymo_scene(cfg, device=dev)
        torch.cuda.synchronize()
    finally:
        for rec in stages.values():
            rec.restore()
    t_load = time.perf_counter() - t0
    parsed = stages["parse"].result
    clouds = parsed.points_xyz_dict
    t_parse, t_clouds, t_png = (stages[k].seconds for k in ("parse", "clouds", "png"))
    views = scene.train_views
    H, W = views[0].H, views[0].W
    log(f"[waymo] loaded in {t_load:.2f} s: parsing and obj_bound masks {t_parse - t_clouds:.2f} s, point "
        f"clouds {t_clouds:.2f} s, of which {len(stages['png'].calls)} PNG decodes (sizes and point colours) "
        f"{t_png:.2f} s; packing and views {t_load - t_parse:.2f} s; native library "
        f"{'loaded' if lib else 'not loaded (scipy and numpy fallback)'}")
    log(f"[waymo] {len(views)} views at {W}x{H}, {scene.table.num_actors} actor(s) "
        f"{scene.table.names[1:]}, LiDAR {clouds['lidar'].shape[0]} background points after the voxel and "
        f"outlier filters, actor clouds {[clouds[k].shape[0] for k in clouds if k.startswith('obj_')]} points "
        f"(grid init below 2,000), packed rows {scene.table.capacity}, "
        f"obj_bound pixels {[int(b.sum()) for b in parsed.obj_bounds[:3]]} in the first frame's views")
    if (W, H) != _resize_shape(SEQ_IMAGE[1], SEQ_IMAGE[0])[:2] or len(views) != 3 * SEQ_FRAMES \
            or scene.table.num_actors < 1:
        raise AssertionError(f"loaded {len(views)} views at {W}x{H}, {scene.table.num_actors} actors")
    t0 = time.perf_counter()
    gts = [load_ground_truth(v, device=dev) for v in views]
    torch.cuda.synchronize()
    log(f"[waymo] ground truth of {len(gts)} views (decode, area resize to {W}x{H}, guidance) on the card "
        f"in {time.perf_counter() - t0:.2f} s")

    # ---- 8c. train across the gate ----
    gate = TRAIN_WARMUP + TRAIN_STEPS
    cfg.optim.densify_until_iter = gate
    params = build_initial_params(cfg, scene, device=dev)
    opts = render_opts_from_cfg(cfg, "train")
    step_fn = make_train_step(cfg, scene.table, scene.pose_data, opts)
    state = init_train_state(params, scene.aux_init)
    gen = torch.Generator(device=dev).manual_seed(0)
    order = np.random.default_rng(0).permutation(len(views))
    view_of = lambda s: order[s % len(views)]  # noqa: E731

    def step(st, **kw):
        i = view_of(st.step)
        return step_fn(st, views[i].frame_input, gts[i], gen, **kw)

    for i in range(TRAIN_WARMUP):
        t0 = time.perf_counter()
        new, sc = step(state)
        while int(sc["overflow"]) != 0:
            opts = dataclasses.replace(opts, instance_capacity=2 * opts.instance_capacity)
            log(f"[waymo] warm-up step {i} dropped {int(sc['overflow'])} instances: instance capacity raised "
                f"to {opts.instance_capacity}")
            step_fn = make_train_step(cfg, scene.table, scene.pose_data, opts)
            new, sc = step(state)
        state = new
        torch.cuda.synchronize()
        log(f"[waymo] warm-up step {i}: {1e3 * (time.perf_counter() - t0):.1f} ms wall, loss "
            f"{float(sc['loss']):.6f}, {int(sc['num_alive'])} alive")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    runs = {}
    for side in ("before", "after"):
        for k in kernels:
            k.launches = 0
        ms, records = [], []
        for _ in range(TRAIN_STEPS):
            if side == "after" and not records:
                at_gate = state
            if side == "before" and len(records) == TRAIN_STEPS - 2:
                before_gate = state
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            state, sc = step(state)
            e1.record()
            torch.cuda.synchronize()
            ms.append(e0.elapsed_time(e1))
            records.append(sc)
        runs[side] = dict(ms=ms, records=records, launches={k.__name__: k.launches for k in kernels})
    peak = torch.cuda.max_memory_allocated(dev)
    for side, run in runs.items():
        for i, sc in enumerate(run["records"]):
            loss = float(sc["loss"])
            if not math.isfinite(loss) or int(sc["overflow"]) != 0:
                raise AssertionError(f"waymo step {side} the gate {i}: loss {loss}, overflow {int(sc['overflow'])}")
            if (side == "after") != ("obj_acc_loss" in sc):
                raise AssertionError(f"waymo step {side} the gate: obj_acc_loss {'missing' if side == 'after' else 'present'}")
            if side == "after" and not float(sc["obj_acc_loss"]) > 0:
                raise AssertionError(f"waymo step after the gate: obj_acc_loss {float(sc['obj_acc_loss'])}")
        ms = run["ms"]
        log(f"[waymo] {TRAIN_STEPS} steps {side} the gate (densify_until_iter {gate}): mean "
            f"{sum(ms) / len(ms):.3f} ms/step (min {min(ms):.3f}, max {max(ms):.3f}); losses "
            f"{[round(float(sc['loss']), 5) for sc in run['records']]}; obj_acc_loss "
            f"{[round(float(sc['obj_acc_loss']), 5) for sc in run['records'] if 'obj_acc_loss' in sc]}; "
            f"launches {run['launches']}")
    for v in flatten_params(state.params).values():
        if not torch.isfinite(v).all():
            raise AssertionError("waymo: non-finite parameter after training")
    before, after = runs["before"]["launches"], runs["after"]["launches"]
    if (before["tile_blend_instances"] != TRAIN_STEPS or before["tile_blend_bwd"] != TRAIN_STEPS
            or after["tile_blend_instances"] != 2 * TRAIN_STEPS or after["tile_blend_bwd"] != 2 * TRAIN_STEPS
            or before["segment_rowsum"] != 2 * TRAIN_STEPS or after["segment_rowsum"] != 3 * TRAIN_STEPS
            or before["expand_runs"] < TRAIN_STEPS or after["expand_runs"] != 2 * before["expand_runs"]):
        raise AssertionError(f"waymo launches before the gate {before}, after {after}")
    log(f"[waymo] peak memory {peak / 2**30:.3f} GiB over the {2 * TRAIN_STEPS} timed steps; the blend "
        f"kernels launch twice a step after the gate")

    # ---- 8d. one step twice from the same state, at the gate ----
    C = scene.table.capacity
    draws = Draws(torch.rand(C, generator=gen, device=dev) < 0.5,
                  torch.rand((H, W, 2), generator=gen, device=dev) - 0.5)
    # the first run's kernel inputs, full render and object render, for 8e
    recs = {"expand_runs": CallRecorder(fill.expand_runs, [fill]),
            "forward": CallRecorder(tile_raster2._forward, [tile_raster2]),
            "tile_blend_bwd": CallRecorder(tile_raster2.tile_blend_bwd, [tile_raster2]),
            "segment_rowsum": CallRecorder(segsum.segment_rowsum, [rasterize, sky_cubemap])}
    try:
        s1, sc1 = step(at_gate, draws=draws)
    finally:
        for rec in recs.values():
            rec.restore()
    s2, _ = step(at_gate, draws=draws)
    for name, a, b in [
        *((f"params {k}", v, flatten_params(s2.params)[k]) for k, v in flatten_params(s1.params).items()),
        *((f"adam {m} {k}", v, getattr(s2.adam, m)[k]) for m in ("mu", "nu", "count")
          for k, v in getattr(s1.adam, m).items()),
        ("aux max_radii", s1.aux.max_radii, s2.aux.max_radii),
    ]:
        if not torch.equal(a, b):
            raise AssertionError(f"waymo step at the gate not bit-reproducible: {name}")
    log(f"[check] one waymo step at the gate twice from the same state: bit-equal (obj_acc_loss "
        f"{float(sc1['obj_acc_loss']):.6f})")
    del s1, s2

    # ---- 8e. the kernels on the gate step's own inputs ----
    errors = gate_step_checks(recs, C, f"loaded view {W}x{H}")
    del recs
    torch.cuda.empty_cache()

    # ---- 8f. the object render's cost, unprofiled: the same states,
    # views and draws through the step with the object loss and
    # through one without it (lambda_reg 0), in turns ----
    cfg_no_obj = copy.deepcopy(cfg)
    cfg_no_obj.optim.lambda_reg = 0.0
    fns = {"with": step_fn, "without": make_train_step(cfg_no_obj, scene.table, scene.pose_data, opts)}
    paired = {"with": [], "without": []}
    for j in range(TRAIN_STEPS):
        i = view_of(at_gate.step + j)
        for which in (("with", "without") if j % 2 == 0 else ("without", "with")):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            fns[which](at_gate, views[i].frame_input, gts[i], draws=draws)
            e1.record()
            torch.cuda.synchronize()
            paired[which].append(e0.elapsed_time(e1))
    mean = {k: sum(v) / len(v) for k, v in paired.items()}
    log(f"[waymo] the same {TRAIN_STEPS} views at the gate, in turns: with the object render "
        f"{mean['with']:.3f} ms/step, without {mean['without']:.3f} (lambda_reg 0): the object render "
        f"adds {mean['with'] - mean['without']:.3f} ms/step; across the gate the means differ by "
        f"{sum(runs['after']['ms']) / TRAIN_STEPS - sum(runs['before']['ms']) / TRAIN_STEPS:.3f} ms/step")
    del fns

    # ---- 8g. profiles of two steps on each side of the gate ----
    from torch.profiler import ProfilerActivity, profile

    from street_gaussians_torch.script import trace_stats

    prof_steps = 2
    busy = {}
    for side, st in (("before", before_gate), ("after", at_gate)):
        trace = os.path.join(tmp, f"{side}.json")
        torch.cuda.synchronize()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(prof_steps + 1)]
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            ev[0].record()
            for k in range(prof_steps):
                st, _ = step(st)
                ev[k + 1].record()
            torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        prof.export_chrome_trace(trace)
        summ = serve.trace_summary(trace, wall, prof_steps, ("object_render", "screen_space", "backward"))
        summ["events_ms"] = [ev[k].elapsed_time(ev[k + 1]) for k in range(prof_steps)]
        summ["stats"] = trace_stats.trace_stats(trace, prof_steps)  # busy ms, kernels, syncs a step
        with open(trace) as f:
            launched = [e for e in serve.device_events(json.load(f)["traceEvents"]) if e["cat"] == "kernel"]
        summ["kernel_busy_ms"] = serve.busy_ms(launched) / prof_steps
        busy[side] = summ
        obj, stats = summ["per_view"]["object_render"], summ["stats"]
        log(f"[waymo] profiled {prof_steps} steps {side} the gate: wall {wall / prof_steps:.3f} ms/step, CUDA "
            f"events {[round(x, 3) for x in summ['events_ms']]} ms; device busy {stats['busy_ms']:.3f} ms/step "
            f"(kernels alone {summ['kernel_busy_ms']:.3f}), idle share {summ['idle_share']:.3f}; "
            f"{stats['kernels']:.1f} kernels and {stats['host_syncs']:.1f} host syncs a step; object_render range: "
            f"{obj['launched_kernel_ms']:.3f} ms of kernels, {obj['launched_kernels']:.0f} kernels, "
            f"{obj['host_syncs']:.1f} host syncs, host {obj['host_ms']:.3f} ms; backward launched "
            f"{summ['per_view']['backward']['launched_kernel_ms']:.3f} ms")
    if not busy["after"]["per_view"]["object_render"]["launched_kernels"] > 0:
        raise AssertionError("waymo: no kernel in the object_render range after the gate")
    del state, at_gate, before_gate, params, scene, gts
    torch.cuda.empty_cache()

    # ---- 8h. card against CPU across the gate ----
    small_step_check(dev, lambda_reg=0.1)
    return {
        "launches": {name: {"before_gate": before[name], "after_gate": after[name]} for name in before},
        "ms_per_step": {side: sum(r["ms"]) / len(r["ms"]) for side, r in runs.items()},
        "peak_gib": peak / 2**30,
        "paired_ms_per_step": mean,
        "object_render_ms": mean["with"] - mean["without"],
        "profiled": {side: {"events_ms": b["events_ms"], "device_busy_ms": b["stats"]["busy_ms"],
                            "kernel_busy_ms": b["kernel_busy_ms"], "kernels": b["stats"]["kernels"],
                            "host_syncs": b["stats"]["host_syncs"],
                            "object_render_kernel_ms": b["per_view"]["object_render"]["launched_kernel_ms"]}
                     for side, b in busy.items()},
        "errors": errors,
    }


RUN_ITERS = 300
RESUME_ITERS = 320
RUN_GATE = 160  # densify_until_iter: the object-opacity loss from here on


def runner_phase(dev, root: str, tmp: str, smi: str) -> dict:
    """Step 9: step 8's sequence through the three CLIs, in-process:
    `train --config configs/example/waymo_train_002.yaml` for RUN_ITERS
    iterations (the watchdog, not this script, grows the capacity;
    densify at 100 and 150; evals and checkpoints at 150 and 300), a
    resume to RESUME_ITERS, `render` (render_sets from the checkpoint at
    300) and `metrics`. Holds the run to its rules (see the checks below)
    and the four main-path kernels, at the step of iteration 300, against
    their plain versions on that step's own inputs. Returns the kernels'
    launches in training and in render_sets, their errors, and the
    numbers printed."""
    from street_gaussians_torch import checkpoint, runner
    from street_gaussians_torch import metrics as metrics_cli
    from street_gaussians_torch import render as render_cli
    from street_gaussians_torch import train as train_cli
    from street_gaussians_torch.config import load_config
    from street_gaussians_torch.data.dataset import load_ground_truth
    from street_gaussians_torch.models.renderer import render_frame
    from street_gaussians_torch.ops import fill, segsum, tile_raster2
    from street_gaussians_torch.script import block_times
    from street_gaussians_torch.train_lib import init_train_state
    from street_gaussians_torch.utils import losses as L
    from street_gaussians_torch.utils import lpips as lpips_lib
    from street_gaussians_torch.utils import ply

    kernels = (fill.expand_runs, tile_raster2.tile_blend_instances, tile_raster2.tile_blend_bwd,
               segsum.segment_rowsum)
    out = os.path.join(tmp, "runner")
    recipe = os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs", "example", "waymo_train_002.yaml")
    opts = ["source_path", root, "model_path", out, "data.selected_frames", f"[0, {SEQ_FRAMES - 1}]",
            "data.use_tracker", "false", "train.test_iterations", f"[150, {RUN_ITERS}]",
            "train.save_iterations", f"[{RUN_ITERS}]", "train.checkpoint_iterations", f"[150, {RUN_ITERS}]",
            "optim.densify_from_iter", "50", "optim.densification_interval", "50",
            "optim.densify_until_iter", str(RUN_GATE), "train.eval_max_views", "5"]
    argv = ["--config", recipe, "--device", dev.type, *opts]
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)

    # the kernels' inputs in the step of iteration RUN_ITERS, for the check
    # against their plain versions (as step 8e)
    recs = {}
    make_step = runner.make_train_step
    # ---- 9a. train ----
    for k in kernels:
        k.launches = 0
    sync()
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    runner.make_train_step = recording_make_step(make_step, RUN_ITERS - 1, recs)
    np.random.seed(0)  # the actor's grid colours
    t0 = time.perf_counter()
    try:
        final = train_cli.main(argv + ["train.iterations", str(RUN_ITERS)])
    finally:
        runner.make_train_step = make_step
    sync()
    t_train = time.perf_counter() - t0
    train_launches = {k.__name__: k.launches for k in kernels}
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    if cuda and any(n == 0 for n in train_launches.values()):
        raise AssertionError(f"runner: a main-path kernel was not launched in training: {train_launches}")
    with open(os.path.join(out, "record", "train_log.jsonl")) as f:
        log_recs = [json.loads(line) for line in f]
    steps = [r for r in log_recs if "loss" in r]
    if [r["iteration"] for r in steps] != list(range(10, RUN_ITERS + 1, 10)):
        raise AssertionError(f"runner: step records at {[r['iteration'] for r in steps]}")
    if not all(math.isfinite(r["loss"]) for r in steps):
        raise AssertionError("runner: a logged loss is not finite")
    dens = [r["iteration"] for r in log_recs if "densify/points_clone" in r]
    if dens != [100, 150]:
        raise AssertionError(f"runner: densify records at {dens}, expected [100, 150]")
    for ev in final["growth"]:
        window = [r for r in steps if ev["iteration"] - 100 < r["iteration"] <= ev["iteration"]]
        hits = sum(1 for r in window if r[f"overflow_{ev['capacity'].split('_')[0]}"] > 0)
        if ev["iteration"] % 100 or len(window) != 10 or hits < 5 or hits != ev["hits"] or (
                ev["to"] != 2 * ev["from"] and ev["to"] != 0):
            raise AssertionError(f"runner: growth {ev} against its window's {hits} hits in {len(window)} samples")
        log(f"[runner] growth at iteration {ev['iteration']}: {ev['capacity']} {ev['from']} -> {ev['to']} "
            f"({ev['hits']}/10 samples overflowed)")
    evals = [r for r in log_recs if "train_psnr" in r]
    if [r["iteration"] for r in evals] != [150, RUN_ITERS]:
        raise AssertionError(f"runner: evals at {[r['iteration'] for r in evals]}")

    # ---- 9b. the checkpoint, the PLY and the checksum ----
    cfg = load_config(recipe, opts, "train")
    np.random.seed(0)
    scene = runner.build_trained_scene(cfg, dev)
    template = init_train_state(runner.build_initial_params(cfg, scene, dev), scene.aux_init)
    state, it = checkpoint.load_train_state(cfg.trained_model_dir, template, RUN_ITERS)
    again_dir = os.path.join(tmp, "resaved")
    checkpoint.save_train_state(again_dir, RUN_ITERS, state)
    again, _ = checkpoint.load_train_state(again_dir, template)
    saved = torch.load(os.path.join(cfg.trained_model_dir, f"iteration_{RUN_ITERS}", checkpoint.STATE_FILE),
                       map_location="cpu", weights_only=True)
    flat, flat2 = checkpoint.state_to_flat(state), checkpoint.state_to_flat(again)
    for k, v in saved.items():
        if not (torch.equal(v, flat[k].cpu()) and torch.equal(v, flat2[k].cpu())):
            raise AssertionError(f"runner: checkpoint leaf {k} not bit-equal after reload and re-save")
    if runner.param_checksum(state.params) != final["param_checksum"]:
        raise AssertionError(f"runner: param_checksum {final['param_checksum']} != the checkpoint's "
                             f"{runner.param_checksum(state.params)}")
    elements = ply.read_ply(os.path.join(cfg.point_cloud_dir, f"iteration_{RUN_ITERS}", "point_cloud.ply"))
    alive = state.aux.alive.cpu().numpy()
    xyz = state.params.gaussians.xyz.cpu().numpy()
    for mi, name in enumerate(scene.table.names):
        s, e = scene.table.slices[mi]
        el = elements[f"vertex_{name}"]
        want = xyz[s:e][alive[s:e]]
        if len(el) != len(want) or not np.array_equal(np.stack([el["x"], el["y"], el["z"]], -1), want):
            raise AssertionError(f"runner: PLY element vertex_{name} does not hold the alive rows")
    log(f"[check] runner checkpoint at {RUN_ITERS}: {len(saved)} leaves bit-equal after reload and re-save; "
        f"param_checksum {final['param_checksum']!r} equal; the PLY holds the {int(alive.sum())} alive rows")

    # ---- 9c. the kernels on the step of iteration RUN_ITERS ----
    C = scene.table.capacity
    errors = gate_step_checks(recs, C, f"runner step {RUN_ITERS}")
    recs.clear()
    # the eval views in eval mode, on the initial weights and on the
    # trained state: run lengths of the first, PSNR of all five
    eval_views = scene.train_views[:5]
    gts = [load_ground_truth(v, device=dev) for v in eval_views]
    psnr0 = []
    for label, st in (("initial weights", template), (f"trained, iteration {RUN_ITERS}", state)):
        rec = CallRecorder(tile_raster2._forward, [tile_raster2])
        try:
            with torch.no_grad():
                psnrs = [float(L.psnr(render_frame(st.params, st.aux, scene.table, scene.pose_data, v.frame_input,
                                                   10**9, opts=runner.render_opts_from_cfg(cfg, "eval"))["rgb"],
                                      gt.image, gt.mask)) for v, gt in zip(eval_views, gts)]
        finally:
            rec.restore()
        psnr0 = psnr0 or psnrs
        log(f"[runs] view {eval_views[0].image_name} in eval mode, {label}: "
            f"{json.dumps(block_times.run_length_stats(rec.calls[0][0][2]))}; PSNR of the {len(eval_views)} eval "
            f"views {[round(x, 4) for x in psnrs]}")
    del gts
    del state, again, template, flat, flat2, saved, scene
    if cuda:
        torch.cuda.empty_cache()

    # ---- 9d. resume ----
    grown = int(final["growth"][-1]["to"]) if final["growth"] else None
    resume_argv = argv + ["train.iterations", str(RESUME_ITERS)]
    if grown:  # the grown capacity is in neither the checkpoint nor the snapshot (as in the JAX package)
        resume_argv += ["render.instance_capacity", str(grown)]
    printed = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(printed):
        resumed = train_cli.main(resume_argv)
    t_resume = time.perf_counter() - t0
    sys.stdout.write(printed.getvalue())
    with open(os.path.join(out, "record", "train_log.jsonl")) as f:
        tail = [json.loads(line)["iteration"] for line in f][len(log_recs):]
    if f"[resume] restored iteration {RUN_ITERS}" not in printed.getvalue() or \
            resumed["start_iteration"] != RUN_ITERS or tail != list(range(RUN_ITERS + 10, RESUME_ITERS + 1, 10)):
        raise AssertionError(f"runner: resume from {resumed['start_iteration']}, new records {tail}")

    # ---- 9e. render and metrics ----
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    served = render_cli.main(["--config", recipe, "--device", dev.type, *opts])
    sync()
    t_render = time.perf_counter() - t0
    render_launches = {k.__name__: k.launches for k in kernels}
    if cuda and (render_launches["expand_runs"] == 0 or render_launches["tile_blend_instances"] == 0):
        raise AssertionError(f"runner: render_sets launched {render_launches}")
    pngs = os.listdir(os.path.join(out, "train_renders"))
    if len(pngs) != 3 * SEQ_FRAMES:
        raise AssertionError(f"runner: render_sets wrote {len(pngs)} PNGs")
    t0 = time.perf_counter()
    scores = metrics_cli.main(["--config", recipe, "--device", dev.type, *opts])
    t_metrics = time.perf_counter() - t0
    tr = scores["train"]
    if not (math.isfinite(tr["psnr"]) and math.isfinite(tr["ssim"]) and len(tr["per_view"]) == 3 * SEQ_FRAMES):
        raise AssertionError(f"runner: metrics {tr['psnr']}, {tr['ssim']} over {len(tr['per_view'])} views")
    # LPIPS only where its weights are found (none ship with the repository)
    found = lpips_lib.load_weights("alex") is not None
    if found != ("lpips" in tr) or found != all("lpips" in v for v in tr["per_view"]):
        raise AssertionError(f"runner: LPIPS weights {'found' if found else 'not found'}, metrics keys {sorted(tr)}")
    log(f"[metrics] LPIPS: {'weights found, ' + format(tr['lpips'], '.4f') if found else 'no weights found'}"
        f" ($SGTPU_LPIPS_WEIGHTS or the torch hub cache): {'reported' if found else 'none reported'}")

    # ---- 9f. the runner on the card against the CPU ----
    if cuda:
        small_runner_check(dev)

    # ---- 9g. numbers ----
    tm = final["timing"]
    other = tm["load_s"] + tm["ground_truth_s"] + tm["eval_s"] + tm["save_s"] + tm["resume_s"]
    stages = {"load_s": tm["load_s"], "first_epoch_ground_truth_s": tm["ground_truth_s"],
              "steps_s": tm["total_s"] - other, "evals_s": tm["eval_s"], "saves_s": tm["save_s"],
              "train_total_s": tm["total_s"], "resume_run_s": t_resume}
    last_growth = max((ev["iteration"] for ev in final["growth"]), default=0)
    clean = [w for w in tm["windows"] if not w["with"]]
    sides = {}
    for side, keep in (("before the gate", lambda w: w["iteration"] <= RUN_GATE),
                       ("after the gate", lambda w: w["iteration"] - 9 > RUN_GATE)):
        ws = [w["ms_per_step"] for w in clean if keep(w) and w["iteration"] - 9 > last_growth]
        sides[side] = {"windows": len(ws), "ms_per_step": sum(ws) / len(ws) if ws else None}
    caps = {}  # mean ms/step of the clean windows at each capacity and side of the gate
    for w in clean:
        cap = max([ev["to"] for ev in final["growth"] if ev["iteration"] < w["iteration"] - 9],
                  default=int(cfg.render.instance_capacity))
        key = f"{cap} {'after' if w['iteration'] - 9 > RUN_GATE else 'before'}"
        caps.setdefault(key, []).append(w["ms_per_step"])
    by_capacity = {k: sum(v) / len(v) for k, v in caps.items()}
    log(f"[runner] {smi}: stages {json.dumps({k: round(v, 3) for k, v in stages.items()})}")
    log(f"[runner] {smi}: ms/step over clean 10-iteration windows after the last growth (iteration "
        f"{last_growth}): {json.dumps(sides)}; by instance capacity and side of the gate: "
        f"{json.dumps(by_capacity)}; peak memory {peak / 2**30:.3f} GiB; GTCache {final['gt_cache_bytes']} bytes "
        f"for {final['gt_cache_views']} views; launches in {RUN_ITERS} iterations {train_launches}")
    log(f"[render] {smi}: ladder {json.dumps(served.get('capacities'))}; {served['render_ms']:.3f} ms/view "
        f"({served['fps']:.3f} FPS), fps_throughput {served['fps_throughput']:.3f}; regrows {served['regrows']}; "
        f"{t_render:.2f} s in all; launches {render_launches}")
    log(f"[metrics] {smi}: train PSNR {tr['psnr']:.4f} SSIM {tr['ssim']:.4f} over {len(tr['per_view'])} views "
        f"({t_metrics:.2f} s); eval train_psnr at 150 and {RUN_ITERS} {evals[0]['train_psnr']:.4f}, "
        f"{evals[-1]['train_psnr']:.4f} against the first logged psnr {steps[0]['psnr']:.4f} and the eval views' "
        f"initial {sum(psnr0) / len(psnr0):.4f}")
    # training improved the eval views: their PSNR at RUN_ITERS (the
    # runner's eval) above the same views' PSNR on the initial weights.
    # (The first logged psnr is another view's, in train mode: the views'
    # PSNRs differ by several dB, so it is printed, not compared.)
    if not evals[-1]["train_psnr"] > sum(psnr0) / len(psnr0):
        raise AssertionError(f"runner: eval train_psnr {evals[-1]['train_psnr']} at {RUN_ITERS} not above the same "
                             f"views' initial {sum(psnr0) / len(psnr0)}")
    return {
        "launches": {k: {"train": train_launches[k], "render_sets": render_launches[k]} for k in train_launches},
        "errors": errors,
        "stages_s": stages,
        "ms_per_step": sides,
        "ms_per_step_by_capacity": by_capacity,
        "growth": final["growth"],
        "peak_gib": peak / 2**30,
        "gt_cache_bytes": final["gt_cache_bytes"],
        "train_s": t_train,
        "render": {k: served[k] for k in ("capacities", "render_ms", "fps", "fps_throughput", "regrows")
                   if k in served},
        "metrics": {"psnr": tr["psnr"], "ssim": tr["ssim"]},
    }


# ---- step 10: semantics and normals through the widened blend kernels ----
WIDE_FEATURES = (7, 24, 27, 64)  # normals; semantics at 20 classes; both; the kernels' cap
SEM_CLASSES = 20  # data.num_classes' default
WIDE_F = 4 + 3 + SEM_CLASSES  # rgb + depth, normals, semantics: 27
WIDE_VIEWS = 4  # views a turn
WIDE_TURNS = 3
WIDE_ITERS = 30  # the runner session on step 8's sequence
WIDE_GATE = 20  # its densify_until_iter: the object render (at F = 27) from here on
WIDE_CAPACITY = 6_291_456  # step 8's capacity for this sequence's initial weights
LPIPS_SEED = 0


def wide_blend_checks(dev, F: int, err: dict) -> None:
    """Step 10a at one F: the instance blend forward and backward (random
    cotangents on every channel) and the table blend forward and
    backward against their plain versions, on the random case and on the
    long runs; the instance backward with and without the forward's state
    bit-equal. Raises past the tolerances of steps 3, 5 and 7; the
    largest errors go into `err`."""
    from street_gaussians_torch.ops import tile_raster, tile_raster2

    gen = torch.Generator(device=dev).manual_seed(F)
    cases = {"random ragged (1200 tiles)": random_blend_case(F, dev, F=F),
             f"long runs (16 tiles, up to {max(LONG_RUNS)} lanes)": long_blend_case(F, dev, LONG_OPACITIES[1], F=F)}
    for what, case in cases.items():
        payload, starts, counts, _, gx, T = case
        out, state = tile_raster2._forward(*case)
        err["tile_blend_instances"] = max(err["tile_blend_instances"], compare_blend(
            out, tile_raster2.tile_blend_plain(*case), F, f"tile_blend F={F} {what}"))
        gout = torch.randn((T, 256, F + 1), generator=gen, device=dev)
        got = tile_raster2.tile_blend_bwd(payload, starts, counts, out, gout, F, gx, T, state=state)
        if not torch.equal(got, tile_raster2.tile_blend_bwd(payload, starts, counts, out, gout, F, gx, T)):
            raise AssertionError(f"tile_blend_bwd F={F} {what}: with and without the forward's state not bit-equal")
        err["tile_blend_bwd"] = max(err["tile_blend_bwd"], compare_blend_bwd(
            got, tile_raster2.tile_blend_bwd_plain(payload, starts, counts, out, gout, F, gx, T),
            live_lanes(payload, starts, counts), F, f"tile_blend_bwd F={F} {what}"))
    tables = {"random table (1200 tiles, K=768)": random_table_case(F, dev, F=F),
              "long table (16 tiles, K=16,896)": random_table_case(
                  F, dev, grid_x=4, grid_y=4, F=F, K=16_896, counts=LONG_RUNS, opacity_hi=0.05)}
    for what, case in tables.items():
        payload, counts, _, gx = case
        out = tile_raster.tile_blend(*case)
        err["tile_blend_table"] = max(err["tile_blend_table"], compare_blend(
            out, tile_raster.tile_blend_plain(*case), F, f"table blend F={F} {what}"))
        gout = torch.randn((counts.numel(), 256, F + 1), generator=gen, device=dev)
        K = payload.shape[2]
        live = (torch.arange(K, device=dev)[None, :] < counts[:, None]).reshape(-1)
        err["tile_blend_table_bwd"] = max(err["tile_blend_table_bwd"], compare_blend_bwd(
            tile_raster.tile_blend_bwd(payload, counts, out, gout, F, gx),
            tile_raster.tile_blend_bwd_plain(payload, counts, out, gout, F, gx), live, F,
            f"table blend backward F={F} {what}"))


def semantic_bench_scene(dev, seed: int = 0, **overrides):
    """serve.bench_scene with semantics at SEM_CLASSES classes, its
    semantic rows uniform in [0, 1) from `seed` (the initial rows are
    zeros, which the blend would sum for nothing)."""
    import dataclasses

    from street_gaussians_torch import serve

    scene, params = serve.bench_scene(seed=seed, device=dev, use_semantic=True, num_classes=SEM_CLASSES, **overrides)
    g = params.gaussians
    sem = torch.rand(g.semantic.shape, generator=torch.Generator().manual_seed(seed)).to(dev)
    return scene, dataclasses.replace(params, gaussians=dataclasses.replace(g, semantic=sem))


def wide_phase(dev, root: str, tmp: str, smi: str) -> dict:
    """Step 10: semantics at SEM_CLASSES classes and normals, F = WIDE_F
    blend features, past the 8 the kernels are instantiated for.
    10a: kernels 2.1, 2.2, 2.5 and 2.6 against their plain versions at F in
    WIDE_FEATURES (random and long-run cases); 10b: the bench serving
    scene with semantics and normals: kernels 2.1 and 2.2 on that frame's
    own inputs (2.2 with random cotangents), their times at F = 4 and F =
    27 in turns, ms/view at F = 4 and 27 and at sky_downsample 1, 2 and 4
    in turns, a small scene card against CPU; the table kernels' F = 27
    times on the random case; 10c: a runner session on step 8's sequence
    with the Waymo recipe, semantics and normals on, across
    densify_until_iter (the step after the gate held against the plain
    kernels), its train step at F = 4 and 27 on the same views in turns,
    then `render --mode trajectory`; 10d: LPIPS at 1600x1067 on weights
    from a seed, card against CPU. Returns the numbers for the kernels
    line and the summary."""
    import dataclasses

    from street_gaussians_torch import checkpoint, runner, serve, visualize
    from street_gaussians_torch import render as render_cli
    from street_gaussians_torch import train as train_cli
    from street_gaussians_torch.config import load_config
    from street_gaussians_torch.data.dataset import load_ground_truth
    from street_gaussians_torch.models.renderer import screen_space
    from street_gaussians_torch.models.sky_cubemap import build_sky_table
    from street_gaussians_torch.ops import fill, rasterize, segsum, tile_raster, tile_raster2
    from street_gaussians_torch.script import block_times
    from street_gaussians_torch.train_lib import Draws, init_train_state, make_train_step
    from street_gaussians_torch.utils import lpips as lpips_lib
    from street_gaussians_torch.utils.image_io import imread

    F = WIDE_F
    out = {"f27": {}, "numbers": {}}
    err = dict.fromkeys(("tile_blend_instances", "tile_blend_bwd", "tile_blend_table", "tile_blend_table_bwd"), 0.0)

    # ---- 10a. the four kernels at wide F ----
    t0 = time.perf_counter()
    for f in WIDE_FEATURES:
        wide_blend_checks(dev, f, err)
    log(f"[wide] kernels 2.1, 2.2, 2.5, 2.6 at F = {list(WIDE_FEATURES)} within tolerance of their plain "
        f"versions ({time.perf_counter() - t0:.2f} s)")
    torch.cuda.empty_cache()

    # ---- 10b. the bench serving scene with semantics and normals ----
    scene, params = semantic_bench_scene(dev)
    frame = scene.frames[0]
    H, W = frame.cam.H, frame.cam.W
    opts4 = serve.SERVE_OPTS
    opts = {4: opts4, F: dataclasses.replace(opts4, use_semantic=True, render_normal=True)}
    with torch.no_grad():
        bins = {}
        for f, o in opts.items():
            screen, composed = screen_space(params, scene.aux, scene.table, scene.pose_data, frame,
                                            serve.SERVE_STEP, opts=o)
            extras = [composed[k] for k in ("normals", "semantic") if composed[k] is not None]
            cfg_r = rasterize.RasterizeConfig(o.tile_capacity, o.instance_capacity, corner_cull=o.corner_cull)
            bins[f] = rasterize.blend_inputs(screen, H, W, torch.cat(extras, -1) if extras else None, config=cfg_r)
        del screen, composed, extras
        bi = bins[F]
        if bi.num_features != F:
            raise AssertionError(f"the semantic bench frame blends {bi.num_features} features, expected {F}")
        gx, T = bi.grid_x, bi.grid_x * bi.grid_y
        b_args = {f: (b.payload, b.bins.tile_start, b.bins.tile_count, f, gx, T) for f, b in bins.items()}
        b_out, state = tile_raster2._forward(*b_args[F])
        b_ref, work = tile_raster2.tile_blend_plain(*b_args[F], return_work=True)
        err["tile_blend_instances"] = max(err["tile_blend_instances"], compare_blend(
            b_out, b_ref, F, f"tile_blend F={F} semantic bench frame ({T} tiles)"))
        gout = torch.randn((T, 256, F + 1), generator=torch.Generator(device=dev).manual_seed(27), device=dev)
        bwd_args = (*b_args[F][:3], b_out, gout, F, gx, T)
        live_mask = live_lanes(*b_args[F][:3])
        got = tile_raster2.tile_blend_bwd(*bwd_args, state=state)
        if not torch.equal(got, tile_raster2.tile_blend_bwd(*bwd_args)):
            raise AssertionError("tile_blend_bwd F=27 semantic bench frame: with and without the state not bit-equal")
        err["tile_blend_bwd"] = max(err["tile_blend_bwd"], compare_blend_bwd(
            got, tile_raster2.tile_blend_bwd_plain(*bwd_args), live_mask, F,
            f"tile_blend_bwd F={F} semantic bench frame ({T} tiles)"))
        del got, b_ref
        log(f"[runs] semantic bench frame: {json.dumps(block_times.run_length_stats(bi.bins.tile_count))}")
        for row in block_times.block_times("tile_blend", lambda: tile_raster2.tile_blend_instances(*b_args[F]), F):
            log(f"[blocks] forward F={F}, semantic bench frame: {json.dumps(row)}")
        for row in block_times.block_times("tile_blend_bwd",
                                           lambda: tile_raster2.tile_blend_bwd(*bwd_args, state=state), F):
            log(f"[blocks] backward F={F}, semantic bench frame: {json.dumps(row)}")
        # F = 4 and F = 27 on the same frame, in turns (4, 27, 27, 4)
        _, state4 = tile_raster2._forward(*b_args[4])
        out4 = tile_raster2.tile_blend_instances(*b_args[4])
        gout4 = gout[..., :5].contiguous()
        bwd4 = (*b_args[4][:3], out4, gout4, 4, gx, T)
        fns = {("fwd", 4): lambda: tile_raster2.tile_blend_instances(*b_args[4]),
               ("fwd", F): lambda: tile_raster2.tile_blend_instances(*b_args[F]),
               ("bwd", 4): lambda: tile_raster2.tile_blend_bwd(*bwd4, state=state4),
               ("bwd", F): lambda: tile_raster2.tile_blend_bwd(*bwd_args, state=state)}
        turns = {k: [] for k in fns}
        for kind in ("fwd", "bwd"):
            for f in (4, F, F, 4):
                turns[(kind, f)].append(cuda_ms(fns[(kind, f)], 10))
        kms = {k: sum(v) / len(v) for k, v in turns.items()}
        fwd_plain = cuda_ms(lambda: tile_raster2.tile_blend_plain(*b_args[F]), 1)
        bwd_plain = cuda_ms(lambda: tile_raster2.tile_blend_bwd_plain(*bwd_args), 1)
    live, evaluated, blended = int(live_mask.sum()), int(work["evaluated"]), int(work["blended"])
    fwd_bound = bound(4 * (live * (6 + F) + T * 256 * (F + 1) + 2 * T), 17 * evaluated + (9 + 2 * F) * blended)
    bwd_bound = bound(4 * (live * (6 + F) + 2 * T * 256 * (F + 1) + bi.payload.numel()),
                      17 * evaluated + (47 + 6 * F) * blended)
    log(f"[wide] {smi}: semantic bench frame ({T} tiles, {live} instances, {evaluated} pairs evaluated, {blended} "
        f"blended), kernel ms in turns F=4/F={F}: forward {turns[('fwd', 4)]} / {turns[('fwd', F)]}, backward "
        f"{turns[('bwd', 4)]} / {turns[('bwd', F)]}; F={F} bounds forward {fwd_bound}, backward {bwd_bound}; "
        f"plain forward {fwd_plain:.3f} ms, backward {bwd_plain:.3f} ms")
    out["f27"]["tile_blend_instances"] = {"ms": kms[("fwd", F)], "plain_ms": fwd_plain, "bound_ms": fwd_bound[0],
                                          "bound_by": fwd_bound[1], "f4_ms_in_turns": kms[("fwd", 4)],
                                          "path": "the semantic bench frame"}
    out["f27"]["tile_blend_bwd"] = {"ms": kms[("bwd", F)], "plain_ms": bwd_plain, "bound_ms": bwd_bound[0],
                                    "bound_by": bwd_bound[1], "f4_ms_in_turns": kms[("bwd", 4)],
                                    "path": "the semantic bench frame, random cotangents"}
    del bins, bi, b_args, b_out, state, state4, out4, gout, gout4, bwd_args, bwd4, fns, live_mask
    torch.cuda.empty_cache()

    # the table kernels at F = 4 and F = 27 on the random case, in turns
    tk = {}
    for f in (4, F):
        case = random_table_case(5, dev, F=f)
        payload, counts, _, gx_t = case
        tout, twork = tile_raster.tile_blend_plain(*case, return_work=True)
        tgout = torch.randn((counts.numel(), 256, f + 1), generator=torch.Generator(device=dev).manual_seed(f),
                            device=dev)
        tk[f] = dict(case=case, bwd=(payload, counts, tout, tgout, f, gx_t), work=twork)
    tturns = {(k, f): [] for k in ("fwd", "bwd") for f in (4, F)}
    for f in (4, F, F, 4):
        tturns[("fwd", f)].append(cuda_ms(lambda: tile_raster.tile_blend(*tk[f]["case"]), 10))
        tturns[("bwd", f)].append(cuda_ms(lambda: tile_raster.tile_blend_bwd(*tk[f]["bwd"]), 5))
    for name, kind, fn_plain in (("tile_blend_table", "fwd", lambda: tile_raster.tile_blend_plain(*tk[F]["case"])),
                                 ("tile_blend_table_bwd", "bwd",
                                  lambda: tile_raster.tile_blend_bwd_plain(*tk[F]["bwd"]))):
        payload, counts = tk[F]["case"][:2]
        Tt, K = payload.shape[0], payload.shape[2]
        n_live = int(torch.minimum(counts, torch.tensor(K, device=dev)).sum())
        ev, bl = int(tk[F]["work"]["evaluated"]), int(tk[F]["work"]["blended"])
        if kind == "fwd":
            bnd = bound(4 * (n_live * (6 + F) + Tt * 256 * (F + 1) + Tt), 17 * ev + (6 + 2 * F) * bl)
        else:
            bnd = bound(4 * (n_live * (6 + F) + 2 * Tt * 256 * (F + 1) + Tt + payload.numel()),
                        17 * ev + (44 + 6 * F) * bl)
        ms = sum(tturns[(kind, F)]) / 2
        out["f27"][name] = {"ms": ms, "plain_ms": cuda_ms(fn_plain, 1), "bound_ms": bnd[0], "bound_by": bnd[1],
                            "f4_ms_in_turns": sum(tturns[(kind, 4)]) / 2,
                            "path": "the random table case (1200 tiles, K=768)"}
    log(f"[wide] {smi}: table kernels on the random case (1200 tiles, K=768), ms in turns F=4/F={F}: forward "
        f"{tturns[('fwd', 4)]} / {tturns[('fwd', F)]}, backward {tturns[('bwd', 4)]} / {tturns[('bwd', F)]}")
    del tk
    torch.cuda.empty_cache()

    # ms/view at F = 4 and F = 27, and at sky_downsample 1, 2 and 4, in turns
    with torch.no_grad():
        sky_table = build_sky_table(params.sky.cubemap)
    variants = {"F=4": opts4, f"F={F}": opts[F],
                **{f"sky_downsample={d}": dataclasses.replace(opts4, sky_downsample=d) for d in (1, 2, 4)}}
    frames = scene.frames[:WIDE_VIEWS]
    for o in variants.values():  # warm-up
        serve.render_views(scene, params, frames[:1], o, device=dev, sky_table=sky_table)
    torch.cuda.synchronize()
    tile_raster2.tile_blend_instances.launches = 0
    view_ms = {k: [] for k in variants}
    names = list(variants)
    for turn in range(WIDE_TURNS):
        for name in (names if turn % 2 == 0 else names[::-1]):
            for fr in frames:
                e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                e0.record()
                (r,) = serve.render_views(scene, params, [fr], variants[name], device=dev, sky_table=sky_table)
                e1.record()
                torch.cuda.synchronize()
                view_ms[name].append(e0.elapsed_time(e1))
                if not all(torch.isfinite(v).all() for v in r.values() if torch.is_tensor(v) and v.is_floating_point()):
                    raise AssertionError(f"semantic bench view, {name}: non-finite output")
                if name == f"F={F}" and (tuple(r["semantic"].shape) != (H, W, SEM_CLASSES)
                                         or tuple(r["normals"].shape) != (H, W, 3)):
                    raise AssertionError(f"semantic bench view: semantic {tuple(r['semantic'].shape)}, "
                                         f"normals {tuple(r['normals'].shape)}")
    serve_launches = tile_raster2.tile_blend_instances.launches
    if serve_launches != WIDE_TURNS * len(variants) * WIDE_VIEWS:
        raise AssertionError(f"the semantic bench views launched tile_blend {serve_launches} times")
    mean_ms = {k: sum(v) / len(v) for k, v in view_ms.items()}
    log(f"[wide] {smi}: ms/view on the bench scene with semantics ({SEM_CLASSES} classes) in turns, "
        f"{WIDE_TURNS} x {WIDE_VIEWS} views each: {json.dumps({k: round(v, 3) for k, v in mean_ms.items()})}")
    out["numbers"]["ms_per_view"] = mean_ms
    out["f27"]["tile_blend_instances"]["serve_launches"] = serve_launches
    del scene, params, sky_table
    torch.cuda.empty_cache()

    # the small scene, card against CPU: semantics, normals, sky_downsample 4
    o_small = dataclasses.replace(opts[F], sky_downsample=4)
    small = []  # the card's render, then the CPU's
    for d in (dev, torch.device("cpu")):
        sc, pr = semantic_bench_scene(d, seed=3, sky_resolution=16, num_bkgd=600, num_actors=2, H=64, W=96)
        small.append(serve.render_views(sc, pr, sc.frames[5:6], o_small, device=d)[0])
    for k in ("rgb", "depth", "acc", "T", "semantic", "normals"):
        e = float((small[0][k].cpu() - small[1][k]).abs().max())
        if not e <= 1e-4:
            raise AssertionError(f"small semantic render {k}: card vs CPU max abs err {e}")
    log(f"[check] small render (64x96, 2 actors, sky, {SEM_CLASSES} classes, normals, sky_downsample 4): card "
        f"within 1e-4 of the CPU")
    del small

    # ---- 10c. a runner session with semantics and normals, across the gate ----
    recipe = os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs", "example", "waymo_train_002.yaml")
    model_path = os.path.join(tmp, "wide")
    run_opts = ["source_path", root, "model_path", model_path, "data.selected_frames", f"[0, {SEQ_FRAMES - 1}]",
                "data.use_tracker", "false", "data.use_semantic", "true", "data.num_classes", str(SEM_CLASSES),
                "render.render_normal", "true", "render.instance_capacity", str(WIDE_CAPACITY),
                "train.test_iterations", "[]", "train.save_iterations", f"[{WIDE_ITERS}]",
                "train.checkpoint_iterations", f"[{WIDE_ITERS}]", "optim.densify_from_iter", "1000",
                "optim.densify_until_iter", str(WIDE_GATE), "train.iterations", str(WIDE_ITERS)]
    argv = ["--config", recipe, "--device", dev.type, *run_opts]
    recs = {}
    make_step = runner.make_train_step
    # the inputs of the step from state.step == WIDE_GATE: the first with the object render
    runner.make_train_step = recording_make_step(make_step, WIDE_GATE, recs)
    counted = (fill.expand_runs, tile_raster2.tile_blend_instances, tile_raster2.tile_blend_bwd, segsum.segment_rowsum)
    for k in counted:
        k.launches = 0
    np.random.seed(0)
    t0 = time.perf_counter()
    try:
        train_cli.main(argv)
    finally:
        runner.make_train_step = make_step
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t0
    run_launches = {k.__name__: k.launches for k in counted}
    with open(os.path.join(model_path, "record", "train_log.jsonl")) as fh:
        steps = [r for r in map(json.loads, fh) if "loss" in r]
    if [r["iteration"] for r in steps] != list(range(10, WIDE_ITERS + 1, 10)) or not all(
            math.isfinite(r["loss"]) for r in steps) or "obj_acc_loss" not in steps[-1]:
        raise AssertionError(f"wide runner: records {steps}")
    # the full render every step, the object render from the gate on
    want_fwd = WIDE_ITERS + (WIDE_ITERS - WIDE_GATE)
    if run_launches["tile_blend_instances"] != want_fwd or run_launches["tile_blend_bwd"] != want_fwd:
        raise AssertionError(f"wide runner launches {run_launches}, expected {want_fwd} blends")
    ply_path = os.path.join(model_path, "point_cloud", f"iteration_{WIDE_ITERS}", "point_cloud.ply")
    with open(ply_path, "rb") as fh:
        header = fh.read(1 << 16).split(b"end_header")[0].decode()
    if f"semantic_{SEM_CLASSES - 1}" not in header or f"semantic_{SEM_CLASSES}" in header:
        raise AssertionError("wide runner: the PLY does not hold the semantic columns")
    log(f"[wide] {smi}: runner session with semantics and normals, {WIDE_ITERS} iterations across "
        f"densify_until_iter {WIDE_GATE} in {t_run:.2f} s; losses {[round(r['loss'], 5) for r in steps]}; "
        f"launches {run_launches}; the PLY has {SEM_CLASSES} semantic columns")
    out["f27"]["tile_blend_instances"]["launches"] = run_launches["tile_blend_instances"]
    out["f27"]["tile_blend_bwd"]["launches"] = run_launches["tile_blend_bwd"]
    out["numbers"]["runner_launches"] = run_launches
    out["numbers"]["runner_s"] = t_run

    # its train step at F = 4 and F = 27 on the same views, in turns
    cfg = load_config(recipe, run_opts, "train")
    np.random.seed(0)
    tscene = runner.build_trained_scene(cfg, dev)
    for k, v in gate_step_checks(recs, tscene.table.capacity, f"F={F} iteration {WIDE_GATE + 1}").items():
        err[k] = max(err.get(k, 0.0), v)
    recs.clear()
    template = init_train_state(runner.build_initial_params(cfg, tscene, dev), tscene.aux_init)
    st, _ = checkpoint.load_train_state(cfg.trained_model_dir, template, WIDE_ITERS)
    del template
    H_seq, W_seq = tscene.train_views[0].H, tscene.train_views[0].W
    o27 = runner.render_opts_from_cfg(cfg, "train")
    o4 = dataclasses.replace(o27, use_semantic=False, render_normal=False)
    step_fns = {4: make_train_step(cfg, tscene.table, tscene.pose_data, o4),
                F: make_train_step(cfg, tscene.table, tscene.pose_data, o27)}
    views = tscene.train_views[:WIDE_VIEWS]
    gts = [load_ground_truth(v, device=dev) for v in views]
    gen = torch.Generator(device=dev).manual_seed(1)
    C = tscene.table.capacity
    draws = [Draws(torch.rand(C, generator=gen, device=dev) < 0.5,
                   torch.rand((v.H, v.W, 2), generator=gen, device=dev) - 0.5) for v in views]
    step_ms = {4: [], F: []}
    for j in range(len(views) + 1):  # the first pair warms up
        for f in ((4, F) if j % 2 == 0 else (F, 4)):
            i = j % len(views)
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            _, sc = step_fns[f](st, views[i].frame_input, gts[i], draws=draws[i])
            e1.record()
            torch.cuda.synchronize()
            if j:
                step_ms[f].append(e0.elapsed_time(e1))
            if not math.isfinite(float(sc["loss"])):
                raise AssertionError(f"wide train step F={f}: loss {float(sc['loss'])}")
    ms_step = {f"F={f}": sum(v) / len(v) for f, v in step_ms.items()}
    log(f"[wide] {smi}: train ms/step after the gate on {len(views)} views in turns: "
        f"{json.dumps({k: round(v, 3) for k, v in ms_step.items()})}")
    out["numbers"]["ms_per_step"] = ms_step
    del st, step_fns, gts, draws, tscene
    torch.cuda.empty_cache()

    # render --mode trajectory: camera 0, the sky on a 1/4 ray grid, no videos
    log("[wide] render --mode trajectory with render.concat_cameras [0], render.sky_downsample 4 and "
        "render.save_video false (the card's machine is not known to have OpenCV)")
    add = visualize.Visualizer.add
    nonfinite = []

    def checked_add(self, name, image_name, img):
        if not np.isfinite(img).all():
            nonfinite.append(f"{image_name}_{name}")
        return add(self, name, image_name, img)

    visualize.Visualizer.add = checked_add
    t0 = time.perf_counter()
    try:
        traj = render_cli.main(["--config", recipe, "--device", dev.type, "--mode", "trajectory", *run_opts,
                                "render.concat_cameras", "[0]", "render.sky_downsample", "4",
                                "render.save_video", "false"])
    finally:
        visualize.Visualizer.add = add
    t_traj = time.perf_counter() - t0
    files = sorted(os.listdir(traj["out_dir"]))
    want = sorted(f"{i:06d}_0_{c}.png" for i in range(SEQ_FRAMES)
                  for c in ("rgb", "object", "background", "depth", "acc"))
    if nonfinite or traj["num_frames"] != SEQ_FRAMES or files != want:
        raise AssertionError(f"trajectory: {traj['num_frames']} frames, non-finite {nonfinite}, files {files}")
    shapes = {imread(os.path.join(traj["out_dir"], f)).shape for f in files}
    if shapes != {(H_seq, W_seq, 3)}:
        raise AssertionError(f"trajectory PNG shapes {shapes}")
    log(f"[wide] trajectory: {traj['num_frames']} frames x 5 channels written, all finite, in {t_traj:.2f} s")
    out["numbers"]["trajectory_s"] = t_traj

    # ---- 10d. LPIPS at 1600x1067 on weights from a seed, card against CPU ----
    rng = np.random.default_rng(LPIPS_SEED)
    pred = rng.random((H_seq, W_seq, 3)).astype(np.float32)
    gt = np.clip(pred + 0.1 * rng.standard_normal(pred.shape), 0, 1).astype(np.float32)
    lp = {}
    for net, size in (("alex", (H_seq, W_seq)), ("vgg", (256, 384))):
        w = lpips_seeded_weights(net, LPIPS_SEED)
        p, g = pred[:size[0], :size[1]], gt[:size[0], :size[1]]
        card = float(lpips_lib.lpips_from_weights(torch.as_tensor(p, device=dev), torch.as_tensor(g, device=dev),
                                                  w, net))
        cpu = float(lpips_lib.lpips_from_weights(torch.as_tensor(p), torch.as_tensor(g), w, net))
        if not (math.isfinite(card) and abs(card - cpu) <= 1e-4 * abs(cpu)):
            raise AssertionError(f"LPIPS {net}: card {card} vs CPU {cpu}")
        lp[net] = {"card": card, "cpu": cpu, "size": list(size)}
    log(f"[wide] LPIPS on weights from seed {LPIPS_SEED}, card against CPU (rtol 1e-4): {json.dumps(lp)}")
    out["numbers"]["lpips"] = lp
    out["errors"] = err
    return out


def lpips_seeded_weights(net_type: str, seed: int) -> dict:
    """LPIPS weights of the net's shapes from a seed: convs N(0, 0.05),
    lin weights |N(0, 1)| (tests/test_lpips.py's recipe)."""
    from street_gaussians_torch.utils import lpips as lpips_lib

    rng = np.random.default_rng(seed)
    arch, _ = lpips_lib._arch(net_type)
    channels = lpips_lib._ALEX_CHANNELS if net_type == "alex" else lpips_lib._VGG_CHANNELS
    w, in_ch, i = {}, 3, 0
    for layer in arch:
        if layer[0] == "conv":
            _, out_ch, k, _, _ = layer
            w[f"conv{i}.weight"] = (rng.standard_normal((out_ch, in_ch, k, k)) * 0.05).astype(np.float32)
            w[f"conv{i}.bias"] = (rng.standard_normal(out_ch) * 0.05).astype(np.float32)
            in_ch, i = out_ch, i + 1
    for li, ch in enumerate(channels):
        w[f"lin{li}.weight"] = np.abs(rng.standard_normal((1, ch, 1, 1))).astype(np.float32)
    return w


def recording_make_step(make_step, at_step: int, recs: dict):
    """A stand-in for runner.make_train_step whose step fns, in the step
    from state.step == at_step, record the four main-path kernels'
    inputs into `recs` (CallRecorders, for gate_step_checks); every step
    fn the runner builds (again after a growth) is wrapped."""
    from street_gaussians_torch.models import sky_cubemap
    from street_gaussians_torch.ops import fill, rasterize, segsum, tile_raster2

    def recording(*a, **kw):
        step_fn = make_step(*a, **kw)

        def step(state, *args, **kwargs):
            if state.step != at_step:
                return step_fn(state, *args, **kwargs)
            recs.update({"expand_runs": CallRecorder(fill.expand_runs, [fill]),
                         "forward": CallRecorder(tile_raster2._forward, [tile_raster2]),
                         "tile_blend_bwd": CallRecorder(tile_raster2.tile_blend_bwd, [tile_raster2]),
                         "segment_rowsum": CallRecorder(segsum.segment_rowsum, [rasterize, sky_cubemap])})
            try:
                return step_fn(state, *args, **kwargs)
            finally:
                for rec in recs.values():
                    rec.restore()

        return step

    return recording


def small_runner_check(dev, iterations: int = 20):
    """runner.training for `iterations` on a small Waymo-format sequence
    (2 frames of camera 0 at 64x96, the vehicle in view; no sky, no flip,
    no densify: nothing drawn), on the card and on the CPU: the logged
    losses within rtol 1e-4, and the saved states under params_close's
    rules (the reference gradient: the CPU run's first Adam moment), rot
    within params_close's bound for noise-level rows (identity rotations
    of isotropic Gaussians have rounding-noise gradients; see
    tests/test_torch_runner.py), integers equal."""
    from street_gaussians_torch import checkpoint, runner
    from street_gaussians_torch.config import load_config
    from street_gaussians_torch.data.synthetic_waymo import write_synthetic_waymo
    from street_gaussians_torch.train_lib import flatten_params, init_train_state

    tmp = tempfile.mkdtemp(prefix="sg_small_runner_")
    try:
        root = os.path.join(tmp, "seq")
        write_synthetic_waymo(root, num_frames=2, cameras=(0,), actor_in_view=True)
        res = []
        for i, d in enumerate((torch.device("cpu"), dev)):
            cfg = load_config(None, [
                "source_path", root, "model_path", os.path.join(tmp, str(i)), "data.type", "Waymo",
                "data.split_train", "1", "data.cameras", "[0]", "model.nsg.include_sky", "false",
                "model.gaussian.flip_prob", "0", "optim.lambda_reg", "0.1", "optim.densify_from_iter", "1000",
                "optim.densify_until_iter", "15", "optim.opacity_reset_interval", "10",
                "train.iterations", str(iterations), "train.test_iterations", "[]", "train.save_iterations", "[]",
                "train.checkpoint_iterations", f"[{iterations}]", "render.instance_capacity", "32768"])
            np.random.seed(0)
            runner.training(cfg, progress=False, device=d)
            with open(os.path.join(cfg.record_dir, "train_log.jsonl")) as f:
                losses = [json.loads(line)["loss"] for line in f]
            np.random.seed(0)
            scene = runner.build_scene(cfg, d)
            tpl = init_train_state(runner.build_initial_params(cfg, scene, d), scene.aux_init)
            state, _ = checkpoint.load_train_state(cfg.trained_model_dir, tpl)
            res.append(dict(losses=losses, params=_numpy(flatten_params(state.params)),
                            mu=_numpy(state.adam.mu), count=_numpy(state.adam.count),
                            alive=state.aux.alive.cpu().numpy(), denom=state.aux.denom.cpu().numpy()))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    b, a = res
    if not np.allclose(a["losses"], b["losses"], rtol=1e-4):
        raise AssertionError(f"small runner losses card {a['losses']} vs CPU {b['losses']}")
    lr = {"gaussians.xyz": 0.00016 * 20.0, "gaussians.feat_dc": 0.0025, "gaussians.feat_rest": 0.0025 / 20,
          "gaussians.log_scale": 0.005, "gaussians.rot": 0.001, "gaussians.opacity_logit": 0.05,
          "actor_pose.opt_trans": 0.0005, "actor_pose.opt_rots": 0.001}
    for k in b["params"]:
        if k == "gaussians.rot":
            if np.abs(a["params"][k] - b["params"][k]).max() > 2 * lr[k] * iterations:
                raise AssertionError("small runner: rot beyond 2 lr per step")
            continue
        params_close(a["params"][k], b["params"][k], b["mu"][k], lr.get(k, 0.0), iterations, f"small runner {k}")
        if not np.array_equal(a["count"][k], b["count"][k]):
            raise AssertionError(f"small runner: count {k} differs")
    if not (np.array_equal(a["alive"], b["alive"]) and np.array_equal(a["denom"], b["denom"])):
        raise AssertionError("small runner: alive rows or visibility counts differ")
    log(f"[check] small runner ({iterations} iterations, 64x96, the vehicle in view, object loss from 15), card vs "
        f"CPU: losses {[round(x, 6) for x in a['losses']]} vs {[round(x, 6) for x in b['losses']]}; parameters "
        f"within params_close, counts and alive rows equal")


def search_only_ms(fn, reps: int) -> float:
    """fn()'s device ms with segsum.cu and fill.cu from their
    search-only probe build (script.search_times)."""
    from street_gaussians_torch.script import search_times

    return search_times.with_build_flags(search_times.PROBE_FLAGS, lambda: cuda_ms(fn, reps))


def kernels_per_call(fn) -> list:
    """Names of the device kernels one fn() launches (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]


def bound(nbytes, ops):
    """(least ms for the work, "bytes" or "operations")."""
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def _numpy(tree):
    return {k: v.detach().cpu().numpy() for k, v in tree.items()}


class CallRecorder:
    """Stands in for a function (a kernel wrapper, a loader stage) under
    its own name in `modules` (where its callers, and a wrapper's own
    launch count, look it up): records each call's arguments, the host
    seconds spent in it and its last result, and forwards `launches` to
    the wrapper."""

    def __init__(self, fn, modules):
        self.fn, self.modules, self.calls = fn, modules, []
        self.seconds, self.result = 0.0, None
        self.__name__ = fn.__name__
        for m in modules:
            setattr(m, fn.__name__, self)

    def __call__(self, *args, **kwargs):
        self.calls.append((args, kwargs))
        t0 = time.perf_counter()
        self.result = self.fn(*args, **kwargs)
        self.seconds += time.perf_counter() - t0
        return self.result

    @property
    def launches(self):
        return self.fn.launches

    @launches.setter
    def launches(self, n):
        self.fn.launches = n

    def restore(self):
        for m in self.modules:
            setattr(m, self.fn.__name__, self.fn)


def gate_step_checks(recs: dict, capacity: int, where: str) -> dict:
    """Step 8e: the four main-path kernels on the inputs that one train
    step at the gate gave them, for the full render and for the object
    render (`recs`: CallRecorders of fill.expand_runs,
    tile_raster2._forward, tile_raster2.tile_blend_bwd and
    segsum.segment_rowsum), against their plain versions at the
    tolerances of steps 3 and 5, with the run lengths of both renders.
    Returns each kernel's largest error."""
    from street_gaussians_torch.ops import fill, segsum, tile_raster2
    from street_gaussians_torch.script import block_times

    n = {k: len(r.calls) for k, r in recs.items()}
    if n != {"expand_runs": 2, "forward": 2, "tile_blend_bwd": 2, "segment_rowsum": 3}:
        raise AssertionError(f"a train step at the gate made {n} kernel calls")
    renders = ("full", "object")  # the order of the forward calls
    err = {}
    with torch.no_grad():
        for label, (args, _) in zip(renders, recs["expand_runs"].calls):
            vals, offs, total, S = args
            if not torch.equal(fill.expand_runs(*args), fill.expand_runs_plain(*args)):
                raise AssertionError(f"expand_runs kernel != plain, {where}, {label} render")
            log(f"[check] expand_runs {where}, {label} render (C={vals.shape[0]}, N={vals.shape[1]}, S={S}, "
                f"total={int(total)}): exact")
        err["expand_runs"] = 0.0
        label_of, err["tile_blend_instances"] = {}, 0.0
        for label, (args, _) in zip(renders, recs["forward"].calls):
            payload, starts, counts, F, gx, T = args
            label_of[payload.data_ptr()] = label
            log(f"[runs] {where}, {label} render: {json.dumps(block_times.run_length_stats(counts))}")
            err["tile_blend_instances"] = max(err["tile_blend_instances"], compare_blend(
                tile_raster2.tile_blend_instances(*args), tile_raster2.tile_blend_plain(*args), F,
                f"tile_blend {where}, {label} render ({T} tiles)"))
        seen, err["tile_blend_bwd"] = [], 0.0
        for args, kw in recs["tile_blend_bwd"].calls:
            payload, starts, counts, out, gout, F, gx, T = args
            label = label_of.get(payload.data_ptr())
            seen.append(label)
            got = tile_raster2.tile_blend_bwd(*args, **kw)
            if not torch.equal(got, tile_raster2.tile_blend_bwd(*args)):
                raise AssertionError(f"tile_blend_bwd {where}, {label} render: with and without the forward's "
                                     f"state not bit-equal")
            err["tile_blend_bwd"] = max(err["tile_blend_bwd"], compare_blend_bwd(
                got, tile_raster2.tile_blend_bwd_plain(*args), live_lanes(payload, starts, counts), F,
                f"tile_blend_bwd {where}, {label} render ({T} tiles)"))
        if sorted(seen, key=str) != sorted(renders):
            raise AssertionError(f"the gate step's backward calls were not one per render: {seen}")
        # the payload calls' keys: the rows in a segment are a prefix
        calls = [(a[0], a[1], kw["num_segments"]) for a, kw in recs["segment_rowsum"].calls]
        rows = sorted((int((k < N).sum()) for _, k, N in calls if N == capacity), reverse=True)
        err["segment_rowsum"] = 0.0
        for d, keys, N in calls:
            what = "sky" if N != capacity else renders[rows.index(int((keys < N).sum()))] + " render's payload"
            what = f"segment_rowsum {where}, {what} (C={d.shape[0]}, L={d.shape[1]}, N={N})"
            got = segsum.segment_rowsum(d, keys, num_segments=N)
            err["segment_rowsum"] = max(err["segment_rowsum"], compare_segsum(
                got, segsum.segment_rowsum_plain(d, keys, num_segments=N),
                segsum.segment_rowsum_plain(d.abs(), keys, num_segments=N), what))
            check_emulated(got, d, keys, N, what)
        if len(rows) != 2:
            raise AssertionError(f"the gate step made {len(rows)} payload row-sums, expected 2")
    return err


def small_step_check(dev, lambda_reg: float = 0.0):
    """Two train steps of a small scene (64x96, 600 background points, 2
    actors flipped with probability 0.5, a 16-texel sky) on the card
    and on the CPU from the same state, ground truth and draws: the
    first step's gradients, then the parameters, moments and statistics
    after two steps, card against CPU. With lambda_reg > 0 the second
    step is at densify_until_iter, so that it renders the actors alone
    for the object-opacity loss, supervised by an obj_bound taken from
    the actors' own render."""
    import dataclasses

    from street_gaussians_torch import train
    from street_gaussians_torch.models.renderer import render_frame, render_object_mask
    from street_gaussians_torch.train_lib import Draws, flatten_params, make_train_step

    # random rotations and anisotropic scales, as in the CPU tests: with
    # the synthetic scene's identity rotations and isotropic scales the
    # rotation gradient is rounding noise and Adam follows its sign
    devices = (torch.device("cpu"), dev)
    cells = [train.bench_train_cell(d, seed=3, sky_resolution=16, num_bkgd=600, num_actors=2, H=64, W=96)
             for d in devices]
    if lambda_reg > 0:
        for i, c in enumerate(cells):
            c.cfg.optim.lambda_reg = lambda_reg
            c.cfg.optim.densify_until_iter = c.state.step + 1
            cells[i] = dataclasses.replace(c, step_fn=make_train_step(c.cfg, c.scene.table, c.scene.pose_data, c.opts))
        c = cells[0]
        with torch.no_grad():
            obj = render_frame(c.state.params, c.scene.aux, c.scene.table, c.scene.pose_data, c.frame, 0,
                               opts=dataclasses.replace(c.opts, mode="eval"),
                               include_mask=render_object_mask(c.scene.table), compose_sky=False)
        cells[0] = dataclasses.replace(c, gt=dataclasses.replace(c.gt, obj_bound=obj["acc"][..., None] > 0.2))
    g0, aux0 = cells[0].state.params.gaussians, cells[0].state.aux
    rng = np.random.default_rng(8)
    C = g0.xyz.shape[0]
    alive = aux0.alive.numpy()[:, None]
    rot = np.where(alive, rng.normal(size=(C, 4)), g0.rot.numpy()).astype(np.float32)
    log_scale = (g0.log_scale.numpy() + rng.uniform(-0.4, 0.4, (C, 3)) * alive).astype(np.float32)
    gt = cells[0].gt
    gen = torch.Generator().manual_seed(7)
    H, W = cells[0].frame.cam.H, cells[0].frame.cam.W
    draws = [Draws((torch.rand(C, generator=gen) < 0.5) & (aux0.model_id > 0),
                   torch.rand((H, W, 2), generator=gen) - 0.5) for _ in range(2)]
    res = []
    for d, cell in zip(devices, cells):
        g = dataclasses.replace(cell.state.params.gaussians, rot=torch.as_tensor(rot, device=d),
                                log_scale=torch.as_tensor(log_scale, device=d))
        state = dataclasses.replace(cell.state, params=dataclasses.replace(cell.state.params, gaussians=g))
        cell_gt = dataclasses.replace(gt, **{f.name: getattr(gt, f.name).to(d) for f in dataclasses.fields(gt)})
        dr = [Draws(x.flip.to(d), x.sky_jitter.to(d)) for x in draws]
        _, _, grads, _, _ = cell.step_fn.loss_and_grads(state, cell.frame, cell_gt, draws=dr[0])
        losses = []
        for i in range(2):
            state, sc = cell.step_fn(state, cell.frame, cell_gt, draws=dr[i])
            losses.append(float(sc["loss"].detach()))
        if lambda_reg > 0 and not float(sc.get("obj_acc_loss", 0.0)) > 0:
            raise AssertionError("small step at the gate: no object-opacity loss")
        res.append(dict(grads=_numpy(grads), params=_numpy(flatten_params(state.params)),
                        mu=_numpy(state.adam.mu), count=_numpy(state.adam.count), losses=losses,
                        accum=state.aux.grad_accum.cpu().numpy(), denom=state.aux.denom.cpu().numpy()))
    b, a = res
    if not np.allclose(a["losses"], b["losses"], rtol=1e-5):
        raise AssertionError(f"small step losses card {a['losses']} vs CPU {b['losses']}")
    lr = {"gaussians.xyz": 0.00016 * 12.0, "gaussians.feat_dc": 0.0025, "gaussians.feat_rest": 0.0025 / 20,
          "gaussians.log_scale": 0.005, "gaussians.rot": 0.001, "gaussians.opacity_logit": 0.05,
          "sky.cubemap": 0.01}
    for k in b["grads"]:
        grads_close(a["grads"][k], b["grads"][k], f"small step grad {k}")
        params_close(a["params"][k], b["params"][k], b["grads"][k], lr.get(k, 0.0), 2, f"small step {k}")
        grads_close(a["mu"][k], b["mu"][k], f"small step mu {k}")
        if not np.array_equal(a["count"][k], b["count"][k]):
            raise AssertionError(f"small step count {k} differs")
    grads_close(a["accum"], b["accum"], "small step grad_accum")
    if not np.array_equal(a["denom"], b["denom"]):
        raise AssertionError("small step denom differs")
    log(f"[check] small train step (64x96, 2 actors, sky 16, lambda_reg {lambda_reg}"
        f"{', second step at the gate' if lambda_reg > 0 else ''}), 2 steps, card vs CPU: losses "
        f"{a['losses']} vs {b['losses']}; gradients, parameters, moments and statistics within the "
        f"CPU tests' tolerances")


def train_phase(dev) -> dict:
    from street_gaussians_torch import train
    from street_gaussians_torch.models import sky_cubemap
    from street_gaussians_torch.ops import fill, rasterize, segsum, tile_raster2
    from street_gaussians_torch.script import block_times, search_times
    from street_gaussians_torch.train_lib import Draws, flatten_params

    # ---- 5a. backward kernels on random inputs ----
    case = random_blend_case(1, dev)
    payload, starts, counts, F, gx, T = case
    gen = torch.Generator().manual_seed(11)
    gout = torch.randn((T, 256, F + 1), generator=gen).to(dev)
    out = tile_raster2.tile_blend_instances(*case)
    got = tile_raster2.tile_blend_bwd(payload, starts, counts, out, gout, F, gx, T)
    ref = tile_raster2.tile_blend_bwd_plain(payload, starts, counts, out, gout, F, gx, T)
    err_bwd = compare_blend_bwd(got, ref, live_lanes(payload, starts, counts), F,
                                "tile_blend_bwd random ragged (1200 tiles)")
    for opacity in LONG_OPACITIES:
        case = long_blend_case(1, dev, opacity)
        payload, starts, counts, F, gx, T = case
        gout = torch.randn((T, 256, F + 1), generator=gen).to(dev)
        out, state = tile_raster2._forward(*case)
        got = tile_raster2.tile_blend_bwd(payload, starts, counts, out, gout, F, gx, T)
        if not torch.equal(got, tile_raster2.tile_blend_bwd(payload, starts, counts, out, gout, F, gx, T, state=state)):
            raise AssertionError("tile_blend_bwd: with and without the forward's state not bit-equal")
        ref = tile_raster2.tile_blend_bwd_plain(payload, starts, counts, out, gout, F, gx, T)
        err_bwd = max(err_bwd, compare_blend_bwd(
            got, ref, live_lanes(payload, starts, counts), F,
            f"tile_blend_bwd long runs (16 tiles, up to {max(LONG_RUNS)} lanes, opacity {opacity})"))
    rng = np.random.default_rng(12)
    keys = torch.as_tensor(np.sort(rng.integers(0, 50_000, 300_000)).astype(np.int32), device=dev)
    d = torch.as_tensor(rng.normal(size=(12, keys.numel())).astype(np.float32), device=dev)
    got = segsum.segment_rowsum(d, keys, num_segments=50_000)
    ref = segsum.segment_rowsum_plain(d, keys, num_segments=50_000)
    err_seg = compare_segsum(got, ref, segsum.segment_rowsum_plain(d.abs(), keys, num_segments=50_000),
                             "segment_rowsum random (C=12, L=300000, N=50000)")
    check_emulated(got, d, keys, 50_000, "segment_rowsum random (C=12, L=300000, N=50000)")

    # ---- 5b. a small train step, card against CPU ----
    small_step_check(dev)

    # ---- 5c. the bench train cell ----
    t0 = time.perf_counter()
    cell = train.bench_train_cell(dev, seed=0)
    torch.cuda.synchronize()
    log(f"[train] bench cell: capacity {cell.scene.table.capacity} rows, {cell.frame.cam.W}x"
        f"{cell.frame.cam.H}, set up in {time.perf_counter() - t0:.2f} s")
    if cell.scene.table.capacity != 661_248:
        raise AssertionError(f"bench train capacity {cell.scene.table.capacity} != 661248")
    gen = torch.Generator(device=dev).manual_seed(0)
    state = cell.state
    # the first warm-up step's own backward inputs, for 5f
    bwd_rec = CallRecorder(tile_raster2.tile_blend_bwd, [tile_raster2])
    seg_rec = CallRecorder(segsum.segment_rowsum, [rasterize, sky_cubemap])
    vjp_recs = {"payload": CallRecorder(rasterize.payload_grad, [rasterize]),
                "sky": CallRecorder(sky_cubemap.bilinear_taps_grad, [sky_cubemap])}
    for i in range(TRAIN_WARMUP):
        t0 = time.perf_counter()
        state, sc = train.run_step(cell, state, gen)
        torch.cuda.synchronize()
        log(f"[train] warm-up step {i}: {1e3 * (time.perf_counter() - t0):.1f} ms wall, "
            f"loss {float(sc['loss']):.6f}")
        if i == 0:
            for rec in (bwd_rec, seg_rec, *vjp_recs.values()):
                rec.restore()
    if len(bwd_rec.calls) != 1 or len(seg_rec.calls) != 2:
        raise AssertionError(f"a train step made {len(bwd_rec.calls)} tile_blend_bwd and "
                             f"{len(seg_rec.calls)} segment_rowsum calls, expected 1 and 2")
    bwd_in, bwd_state = bwd_rec.calls[0][0], bwd_rec.calls[0][1].get("state")
    if bwd_state is None:
        raise AssertionError("the train step's backward ran without the forward's boundary state")
    seg_in = [(a[0], a[1], kw["num_segments"]) for a, kw in seg_rec.calls]
    # kept on the host until 5f, so that they leave the steps' peak memory as it was
    vjp_in = {what: [a.cpu() if torch.is_tensor(a) else a for a in rec.calls[0][0]]
              for what, rec in vjp_recs.items()}
    for rec in vjp_recs.values():
        rec.calls.clear()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    for k in (fill.expand_runs, tile_raster2.tile_blend_instances, tile_raster2.tile_blend_bwd,
              segsum.segment_rowsum):
        k.launches = 0
    step_ms, records = [], []
    for i in range(TRAIN_STEPS):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        state, sc = train.run_step(cell, state, gen)
        e1.record()
        torch.cuda.synchronize()
        step_ms.append(e0.elapsed_time(e1))
        records.append(sc)
    launches = {k.__name__: k.launches for k in (
        fill.expand_runs, tile_raster2.tile_blend_instances, tile_raster2.tile_blend_bwd,
        segsum.segment_rowsum)}
    peak = torch.cuda.max_memory_allocated(dev)
    for i, sc in enumerate(records):
        loss = float(sc["loss"])
        if not math.isfinite(loss) or int(sc["overflow"]) != 0:
            raise AssertionError(f"train step {i}: loss {loss}, overflow {int(sc['overflow'])}")
        log(f"[train] step {TRAIN_WARMUP + i}: {step_ms[i]:.3f} ms, loss {loss:.6f}, psnr "
            f"{float(sc['psnr']):.3f}, overflow 0, alive {int(sc['num_alive'])}")
    for k, v in flatten_params(state.params).items():
        if not torch.isfinite(v).all():
            raise AssertionError(f"non-finite parameter {k} after training")
    if (launches["tile_blend_bwd"] != TRAIN_STEPS or launches["tile_blend_instances"] != TRAIN_STEPS
            or launches["segment_rowsum"] < 2 * TRAIN_STEPS or launches["expand_runs"] < TRAIN_STEPS):
        raise AssertionError(f"train path launches {launches} for {TRAIN_STEPS} steps")
    log(f"[train] {TRAIN_STEPS} steps: mean {sum(step_ms) / TRAIN_STEPS:.3f} ms/step (min "
        f"{min(step_ms):.3f}, max {max(step_ms):.3f}); peak memory {peak / 2**30:.3f} GiB; "
        f"launches {launches}")

    # ---- 5d. determinism: one step twice from the same state ----
    C = cell.scene.table.capacity
    H, W = cell.frame.cam.H, cell.frame.cam.W
    draws = Draws(torch.rand(C, generator=gen, device=dev) < 0.5,
                  torch.rand((H, W, 2), generator=gen, device=dev) - 0.5)
    (s1, _), (s2, _) = (cell.step_fn(state, cell.frame, cell.gt, draws=draws) for _ in range(2))
    for name, a, b in [
        *((f"params {k}", v, flatten_params(s2.params)[k]) for k, v in flatten_params(s1.params).items()),
        *((f"adam {m} {k}", v, getattr(s2.adam, m)[k]) for m in ("mu", "nu", "count")
          for k, v in getattr(s1.adam, m).items()),
        ("aux grad_accum", s1.aux.grad_accum, s2.aux.grad_accum),
        ("aux max_radii", s1.aux.max_radii, s2.aux.max_radii),
    ]:
        if not torch.equal(a, b):
            raise AssertionError(f"train step not bit-reproducible: {name}")
    log("[check] one bench train step twice from the same state: bit-equal parameters, moments, statistics")
    del s1, s2

    # ---- 5e. densify and reset once each, then one more step ----
    n0 = int(state.aux.alive.sum())
    state, diag = cell.densify_fn(state, gen, True)
    state = cell.reset_fn(state)
    state, sc = cell.step_fn(state, cell.frame, cell.gt, gen)
    torch.cuda.synchronize()
    loss = float(sc["loss"])
    if not math.isfinite(loss) or int(sc["overflow"]) != 0:
        raise AssertionError(f"step after densify: loss {loss}, overflow {int(sc['overflow'])}")
    log(f"[train] densify (clone {int(diag['points_clone'])}, split {int(diag['points_split'])}, pruned "
        f"{int(diag['points_pruned'])}, dropped {int(diag['points_dropped'])}): alive {n0} -> "
        f"{int(state.aux.alive.sum())}; reset; next step loss {loss:.6f}, overflow 0")
    capacity = C
    del state, cell
    torch.cuda.empty_cache()

    # ---- 5f. backward kernels on the bench step's own inputs, timed ----
    with torch.no_grad():
        payload, starts, counts, out, gout, F, gx, T = bwd_in
        live_mask = live_lanes(payload, starts, counts)
        log(f"[runs] bench train step: {json.dumps(block_times.run_length_stats(counts))}")
        for row in block_times.block_times("tile_blend_bwd", lambda: tile_raster2.tile_blend_bwd(*bwd_in, state=bwd_state), F):
            log(f"[blocks] backward, bench train step: {json.dumps(row)}")
        got = tile_raster2.tile_blend_bwd(*bwd_in, state=bwd_state)
        if not torch.equal(got, tile_raster2.tile_blend_bwd(*bwd_in)):
            raise AssertionError("tile_blend_bwd bench step: with and without the forward's state not bit-equal")
        ref = tile_raster2.tile_blend_bwd_plain(*bwd_in)
        err_bwd = max(err_bwd, compare_blend_bwd(got, ref, live_mask, F, f"tile_blend_bwd bench step ({T} tiles)"))
        _, work = tile_raster2.tile_blend_plain(payload, starts, counts, F, gx, T, return_work=True)
        evaluated, blended = int(work["evaluated"]), int(work["blended"])
        live = int(live_mask.sum())
        # as the train step calls it, and without the forward's state
        bwd_ms = cuda_ms(lambda: tile_raster2.tile_blend_bwd(*bwd_in, state=bwd_state), 10)
        bwd_no_state = cuda_ms(lambda: tile_raster2.tile_blend_bwd(*bwd_in), 10)
        bwd_plain = cuda_ms(lambda: tile_raster2.tile_blend_bwd_plain(*bwd_in), 2)
        bwd_bytes = 4 * (live * (6 + F) + 2 * T * 256 * (F + 1) + payload.numel())
        # f32 operations: the forward's re-walk (17 per evaluated pair,
        # 9 + 2F per blended pair, as above) plus the gradient terms of
        # a blended pair (30 + 3F) and its share of the 256-pixel sums
        # (8 + F adds)
        bwd_ops = 17 * evaluated + (47 + 6 * F) * blended
        seg = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bytes": 0, "calls": []}
        # the sky's call comes first (the backward runs in reverse)
        for d, keys, N in sorted(seg_in, key=lambda a: a[2] != capacity):
            what = "payload" if N == capacity else "sky"
            got = segsum.segment_rowsum(d, keys, num_segments=N)
            ref = segsum.segment_rowsum_plain(d, keys, num_segments=N)
            abs_sum = segsum.segment_rowsum_plain(d.abs(), keys, num_segments=N)
            err_seg = max(err_seg, compare_segsum(
                got, ref, abs_sum, f"segment_rowsum bench step {what} (C={d.shape[0]}, L={d.shape[1]}, N={N})"))
            if not torch.equal(got, segsum.segment_rowsum(d, keys, num_segments=N)):
                raise AssertionError(f"segment_rowsum {what}: repeat not bit-equal")
            check_emulated(got, d, keys, N, f"segment_rowsum bench step {what}")
            names = kernels_per_call(lambda: segsum.segment_rowsum(d, keys, num_segments=N))
            log(f"[check] segment_rowsum bench step {what}: {len(names)} kernel launches per call {names}")
            if not 1 <= len(names) <= 2:
                raise AssertionError(f"segment_rowsum {what}: {len(names)} launches per call, at most 2")
            nv = int((keys < N).sum())  # the rows in a segment: a prefix of the sorted keys
            lib = lambda: d.new_zeros((d.shape[0], N)).index_add_(1, keys[:nv], d[:, :nv])  # noqa: E731
            call = {"what": what, "C": d.shape[0], "L": d.shape[1], "N": N,
                    "ms": cuda_ms(lambda: segsum.segment_rowsum(d, keys, num_segments=N), 20),
                    "plain_ms": cuda_ms(lambda: segsum.segment_rowsum_plain(d, keys, num_segments=N), 5),
                    "library_ms": cuda_ms(lib, 20),
                    "bytes": 4 * (d.numel() + keys.numel() + d.shape[0] * N)}
            call["bound_ms"] = bound(call["bytes"], 0)[0]
            call["search_only_ms"] = search_only_ms(lambda: segsum.segment_rowsum(d, keys, num_segments=N), 20)
            log(f"[probe] segment_rowsum {what}: whole {call['ms']:.4f} ms, search only "
                f"{call['search_only_ms']:.4f} ms")
            seg["calls"].append(call)
            for k in ("ms", "plain_ms", "library_ms", "bytes"):
                seg[k] += call[k]
            log(f"[kernel] segment_rowsum {what}: {call['ms']:.4f} ms (plain {call['plain_ms']:.4f}, "
                f"index_add_ {call['library_ms']:.4f}), bound {call['bound_ms']:.4f} ms by bytes")
        vjp = {}
        on_card = {k: [a.to(dev) if torch.is_tensor(a) else a for a in v] for k, v in vjp_in.items()}
        for what, stages in (("payload", search_times.payload_stages(*on_card["payload"])[0]),
                             ("sky", search_times.sky_stages(*on_card["sky"])[0])):
            vjp[what] = {f"{k}_ms": cuda_ms(fn, 10) for k, fn in stages.items()}
            log(f"[vjp] {what} gradient step, bench train step: {json.dumps(vjp[what])}")
        del vjp_in, on_card
    log(f"[kernel] bench-step counts: tile_blend_bwd bytes {bwd_bytes}, f32 ops {bwd_ops} "
        f"({evaluated} pairs evaluated, {blended} blended); segment_rowsum bytes {seg['bytes']} per step")
    return {
        "launches": launches,
        "kernels": [
            ("tile_blend_bwd", "street_gaussians_torch/csrc/tile_blend_bwd.cu",
             "street_gaussians_tpu/ops/tile_raster2.py:385", launches["tile_blend_bwd"], err_bwd,
             bwd_ms, bwd_plain, None, bound(bwd_bytes, bwd_ops),
             {"step_ms": sum(step_ms) / TRAIN_STEPS, "without_forward_state_ms": bwd_no_state}),
            ("segment_rowsum", "street_gaussians_torch/csrc/segsum.cu",
             "street_gaussians_tpu/ops/segsum.py:73", launches["segment_rowsum"], err_seg,
             seg["ms"], seg["plain_ms"], seg["library_ms"], bound(seg["bytes"], 0),
             {"per": "both calls of one step", "calls": seg["calls"], "vjp": vjp}),
        ],
    }


# ---- step 11: tile-row bands and camera data parallel ----
PAR_BANDS = (2, 4)
PAR_TURNS = 3
PAR_VIEWS = (0, 1)  # the bench scene's views of the two camera ranks
PAR_ITERS = 10  # runner iterations on step 8's sequence
PAR_FRAMES = 2  # of its frames (6 views)
PAR_CAPACITY = 6_291_456  # 3,145,728 a band at tile_shards 2
PAR_TRAIN_CAPACITY = 4 * 1024 * 1024  # the bench cell with parallel_cell's scales


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def band_edge_rows(H: int, D: int) -> list:
    """The rows where the JAX package's joined bands may differ from its
    whole frame at sky_downsample 2 (ROADMAP.md queue 3): the two rows
    beside each band edge, where a band's own upsample clamps, and the
    image's last row when the last band reaches past it."""
    from street_gaussians_torch.parallel.tiles import band_layout

    lay = band_layout(H, D)
    rows = lay.gy_local * 16
    edges = {r for d in range(1, D) for r in (d * rows - 1, d * rows)}
    if lay.H_pad > H:
        edges.add(H - 1)
    return sorted(r for r in edges if r < H)


def by_row(name: str, a):
    """A parameter leaf with its rows first: the sky's [3, texels]
    cubemap as [texels, 3], so that grads_close and params_close count
    texels, not channels."""
    return a.T if name == "sky.cubemap" else a


def compare_frames(got: dict, ref: dict, what: str, rows=None) -> float:
    """A frame's rgb, depth and acc against another's at the blend
    tolerances (compare_blend), on `rows` (default all)."""
    def stack(o):
        x = torch.cat([o["rgb"], o["depth"][..., None], o["acc"][..., None]], dim=-1)
        return x if rows is None else x[rows]

    return compare_blend(stack(got), stack(ref), 5, what)


def parallel_cell(device, **overrides):
    """Step 11's train cell: the bench train cell (its scene entries
    replaced by `overrides`) with random rotations and anisotropic
    scales, drawn on the CPU from a fixed seed (the same on every rank),
    as small_step_check and the CPU tests do: with the synthetic scene's
    identity rotations and isotropic scales the rotation gradient is
    rounding noise, whose sign Adam follows; its ground truth view_gt's;
    an instance capacity of PAR_TRAIN_CAPACITY."""
    import dataclasses

    from street_gaussians_torch import train
    from street_gaussians_torch.train_lib import make_train_step

    cell = train.bench_train_cell(device, seed=0, **overrides)
    g0, alive = cell.state.params.gaussians, cell.state.aux.alive.cpu().numpy()[:, None]
    rng = np.random.default_rng(8)
    C = g0.xyz.shape[0]
    rot = np.where(alive, rng.normal(size=(C, 4)), g0.rot.cpu().numpy()).astype(np.float32)
    log_scale = (g0.log_scale.cpu().numpy() + rng.uniform(-0.4, 0.4, (C, 3)) * alive).astype(np.float32)
    g = dataclasses.replace(g0, rot=torch.as_tensor(rot, device=device),
                            log_scale=torch.as_tensor(log_scale, device=device))
    state = dataclasses.replace(cell.state, params=dataclasses.replace(cell.state.params, gaussians=g))
    # the larger scales need more instances than the bench capacity
    opts = dataclasses.replace(cell.opts, instance_capacity=PAR_TRAIN_CAPACITY, tile_capacity=PAR_TRAIN_CAPACITY)
    cell = dataclasses.replace(cell, state=state, opts=opts,
                               step_fn=make_train_step(cell.cfg, cell.scene.table, cell.scene.pose_data, opts))
    return dataclasses.replace(cell, gt=view_gt(cell, train.GT_FRAME))


def view_gt(cell, i: int):
    """Ground truth for the cell's view i: the eval render of frames[i]
    plus noise (normal, sigma 0.05, from a CPU generator seeded with i;
    clipped to [0, 1]), as the CPU tests' ground truth. The render's own
    image would make the L1 gradient the sign of rounding noise wherever
    two orders of sums differ by an ulp."""
    import dataclasses

    from street_gaussians_torch import serve
    from street_gaussians_torch.models.renderer import render_frame

    frame = cell.scene.frames[i]
    with torch.no_grad():
        image = render_frame(cell.state.params, cell.scene.aux, cell.scene.table, cell.scene.pose_data, frame,
                             serve.SERVE_STEP, opts=dataclasses.replace(cell.opts, mode="eval"))["rgb"]
    noise = 0.05 * torch.randn(tuple(image.shape), generator=torch.Generator().manual_seed(i))
    return dataclasses.replace(cell.gt, image=torch.clamp(image + noise.to(image.device), 0.0, 1.0))


def _launch_counts() -> dict:
    from street_gaussians_torch.ops import fill, segsum, tile_raster2

    return {k.__name__: k.launches for k in (fill.expand_runs, tile_raster2.tile_blend_instances,
                                             tile_raster2.tile_blend_bwd, segsum.segment_rowsum)}


def _zero_counts() -> None:
    from street_gaussians_torch.ops import fill, segsum, tile_raster2

    for k in (fill.expand_runs, tile_raster2.tile_blend_instances, tile_raster2.tile_blend_bwd,
              segsum.segment_rowsum):
        k.launches = 0


def _state_hash(state) -> str:
    import hashlib

    from street_gaussians_torch.train_lib import flatten_params

    h = hashlib.sha256()
    for k, v in sorted(flatten_params(state.params).items()):
        h.update(k.encode())
        h.update(v.detach().cpu().numpy().tobytes())
    for k in ("alive", "grad_accum", "denom", "max_radii"):
        h.update(getattr(state.aux, k).cpu().numpy().tobytes())
    return h.hexdigest()


def camera_rank(rank: int, world: int, workdir: str, overrides: dict) -> None:
    """Step 11c's rank (torch.multiprocessing.spawn): a Gloo group of
    `world` ranks on cuda:0 (one card shared); the bench train cell (its scene entries
    replaced by `overrides`), rank 0's state on every rank, this rank's
    view PAR_VIEWS[rank], one camera-parallel step in one band and in two
    (data x tile) from the same state and draws, then timed steps; saves
    its launches, times, state hashes and (rank 0) the states."""
    import dataclasses

    from street_gaussians_torch.parallel import comm, dp
    from street_gaussians_torch.train_lib import flatten_params

    group = comm.init_group(rank, world, "file://" + os.path.join(workdir, "rendezvous"), device="cuda:0")
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        cell = parallel_cell(group.device, **overrides)
        state = dp.broadcast_state(cell.state, group)
        frame, gt = cell.scene.frames[PAR_VIEWS[rank]], view_gt(cell, PAR_VIEWS[rank])
        res = {"initial_hash": _state_hash(state), "steps": {}}
        for D in (1, 2):
            # each band at the frame's capacity (11a)
            opts = dataclasses.replace(cell.opts, instance_capacity=D * cell.opts.instance_capacity)
            step = dp.make_data_parallel_train_step(cell.cfg, cell.scene.table, cell.scene.pose_data, opts,
                                                    group, tile_shards=D)
            _zero_counts()
            s1, sc = step(state, frame, gt, torch.Generator(device=group.device).manual_seed(0))
            torch.cuda.synchronize()
            out = {"launches": _launch_counts(), "hash": _state_hash(s1), "loss": float(sc["loss"]),
                   "overflow": int(sc["overflow"])}
            if rank == 0:
                out["params"] = _numpy(flatten_params(s1.params))
                out["aux"] = {k: getattr(s1.aux, k).cpu().numpy() for k in ("grad_accum", "denom", "max_radii")}
            ms, s = [], s1
            gen = torch.Generator(device=group.device).manual_seed(1)
            for _ in range(PAR_TURNS):
                torch.distributed.barrier()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                s, _ = step(s, frame, gt, gen)
                torch.cuda.synchronize()
                ms.append(1e3 * (time.perf_counter() - t0))
            out["ms"] = ms
            res["steps"][D] = out
        torch.save(res, os.path.join(workdir, f"rank{rank}.pt"))
    finally:
        comm.close_group()


def serve_bands(dev, scene, params) -> dict:
    """11a: the bench frame in 2 and 4 bands in turn. At the frame's
    capacity split D ways (the JAX package's band capacity) the bands
    drop instances: the summed counters say how many. At a band capacity
    from each band's demand (sum(tiles_touched) of its clipped screen,
    render_sets' probe) the joined bands against the whole frame, at
    sky_downsample 1 (every row) and 2 (the serving options: every row
    but band_edge_rows'), radii equal, the counters summed and 0;
    kernels 2.1 and 2.3 against their plain versions on each band's own
    inputs (4 bands: the last reaches past the image); an empty band (a
    32-row frame in 4 bands); ms/view and peak memory at D = 1, 2, 4 in
    turns."""
    import dataclasses

    from street_gaussians_torch import serve
    from street_gaussians_torch.models.renderer import render_frame, screen_space
    from street_gaussians_torch.models.sky_cubemap import build_sky_table
    from street_gaussians_torch.ops import fill, tile_raster2
    from street_gaussians_torch.ops.preprocess import clip_screen_to_rows
    from street_gaussians_torch.parallel import tiles

    frame = scene.frames[0]
    H = frame.cam.H
    with torch.no_grad():
        sky_table = build_sky_table(params.sky.cubemap)

    def renderer(opts, D, sc=scene, pr=params, table=sky_table):
        if D == 1:
            return lambda f: render_frame(pr, sc.aux, sc.table, sc.pose_data, f, serve.SERVE_STEP, opts=opts,
                                          sky_table=table)
        band = tiles.make_row_sharded_render(sc.table, sc.pose_data, opts, D)
        return lambda f: band(pr, sc.aux, f, sky_table=table)

    C = serve.SERVE_OPTS.instance_capacity
    err, launches, out = {"expand_runs": 0.0, "tile_blend_instances": 0.0}, {}, {"split_capacity": {}}
    band_opts = {1: serve.SERVE_OPTS}
    with torch.no_grad():
        whole = renderer(serve.SERVE_OPTS, 1)(frame)
        screen, _ = screen_space(params, scene.aux, scene.table, scene.pose_data, frame, serve.SERVE_STEP,
                                 serve.SERVE_OPTS)
        for D in PAR_BANDS:
            lay = tiles.band_layout(H, D)
            need = [int(clip_screen_to_rows(screen, *lay.band(d)).tiles_touched.sum()) for d in range(D)]
            cap = tiles.band_capacity(C, D)
            got = renderer(serve.SERVE_OPTS, D)(frame)
            if int(got["num_instances"]) != int(whole["num_instances"]):
                raise AssertionError(f"{D} bands: {int(got['num_instances'])} instances, the whole frame "
                                     f"{int(whole['num_instances'])}")
            out["split_capacity"][D] = {"band_capacity": cap, "band_demand": need,
                                        "overflow_instance": int(got["overflow_instance"])}
            log(f"[parallel] bench frame in {D} bands at the capacity {C} split {D} ways ({cap} a band): band "
                f"demands (sum of tiles_touched) {need}; instances {int(got['num_instances'])}, dropped "
                f"{int(got['overflow_instance'])} (the summed counter)")
            band_opts[D] = dataclasses.replace(serve.SERVE_OPTS, instance_capacity=D * _round_up(max(need), 128))
        del screen
        for ds in (1, 2):
            whole = renderer(dataclasses.replace(serve.SERVE_OPTS, sky_downsample=ds), 1)(frame)
            for D in PAR_BANDS:
                opts = dataclasses.replace(band_opts[D], sky_downsample=ds)
                torch.cuda.synchronize()
                _zero_counts()
                got = renderer(opts, D)(frame)
                torch.cuda.synchronize()
                n = _launch_counts()
                launches[f"D{D}_ds{ds}"] = n
                if n["tile_blend_instances"] != D or n["expand_runs"] < D:
                    raise AssertionError(f"a view in {D} bands launched {n}")
                if not torch.equal(got["radii"], whole["radii"]):
                    raise AssertionError(f"{D} bands: radii differ from the whole frame's")
                if int(got["overflow"]) != 0 or int(got["num_instances"]) != int(whole["num_instances"]):
                    raise AssertionError(f"{D} bands: overflow {int(got['overflow'])}, instances "
                                         f"{int(got['num_instances'])} vs {int(whole['num_instances'])}")
                what = f"bench frame in {D} bands against the whole frame, sky_downsample {ds}"
                if ds == 1:
                    compare_frames(got, whole, what)
                else:
                    edges = band_edge_rows(H, D)
                    keep = torch.ones(H, dtype=torch.bool, device=dev)
                    keep[edges] = False
                    compare_frames(got, whole, f"{what}, rows {edges} left out", keep)
                    d = (got["rgb"][edges] - whole["rgb"][edges]).abs().max()
                    log(f"[parallel] {what}: rows {edges} (band edges, the reference's own upsample) differ by "
                        f"up to {float(d):.3e}")

        # kernels 2.1 and 2.3 on each band's own inputs (4 bands)
        recs = {"expand_runs": CallRecorder(fill.expand_runs, [fill]),
                "forward": CallRecorder(tile_raster2._forward, [tile_raster2])}
        try:
            renderer(band_opts[4], 4)(frame)
        finally:
            for r in recs.values():
                r.restore()
        lay = tiles.band_layout(H, 4)
        for d, ((a_args, _), (b_args, _)) in enumerate(zip(recs["expand_runs"].calls, recs["forward"].calls)):
            where = f"band {d} of 4 (tile rows {lay.band(d)}{', past the image' if (d + 1) * lay.gy_local > lay.gy else ''})"
            if not torch.equal(fill.expand_runs(*a_args), fill.expand_runs_plain(*a_args)):
                raise AssertionError(f"expand_runs kernel != plain on the bench frame's {where}")
            err["tile_blend_instances"] = max(err["tile_blend_instances"], compare_blend(
                tile_raster2.tile_blend_instances(*b_args), tile_raster2.tile_blend_plain(*b_args), b_args[3],
                f"tile_blend bench frame's {where} ({b_args[5]} tiles, {int(b_args[2].sum())} instances)"))
        log(f"[check] expand_runs on the bench frame's 4 bands' own inputs: exact")

        # an empty band: a 32-row frame in 4 bands (bands 2 and 3 past it)
        sc, pr = serve.bench_scene(seed=3, device=dev, sky_resolution=16, num_bkgd=600, num_actors=2, H=32, W=48)
        small_table = build_sky_table(pr.sky.cubemap)
        ds1 = dataclasses.replace(serve.SERVE_OPTS, sky_downsample=1)
        recs = {"forward": CallRecorder(tile_raster2._forward, [tile_raster2]),
                "expand_runs": CallRecorder(fill.expand_runs, [fill])}
        try:
            _zero_counts()
            got = renderer(ds1, 4, sc, pr, small_table)(sc.frames[1])
            n = _launch_counts()
        finally:
            for r in recs.values():
                r.restore()
        whole = renderer(ds1, 1, sc, pr, small_table)(sc.frames[1])
        compare_frames(got, whole, "a 32x48 frame in 4 bands (bands 2 and 3 empty) against the whole frame, "
                                   "sky_downsample 1")
        counts = [int(a[2].sum()) for a, _ in recs["forward"].calls]
        if n["tile_blend_instances"] != 4 or counts[2:] != [0, 0] or min(counts[:2]) == 0:
            raise AssertionError(f"the 32-row frame's bands: {n}, instances {counts}")
        for a, _ in recs["forward"].calls[2:]:
            err["tile_blend_instances"] = max(err["tile_blend_instances"], compare_blend(
                tile_raster2.tile_blend_instances(*a), tile_raster2.tile_blend_plain(*a), a[3],
                f"tile_blend on an empty band ({a[5]} tiles)"))
        for a, _ in recs["expand_runs"].calls[2:]:
            if not torch.equal(fill.expand_runs(*a), fill.expand_runs_plain(*a)):
                raise AssertionError("expand_runs kernel != plain on an empty band")
        log(f"[check] empty bands: instances per band {counts}, launches {n}; kernels equal their plain versions")
        del sc, pr, small_table, got, whole

        # times and peak memory, in turns
        fns = {D: renderer(band_opts[D], D) for D in (1, *PAR_BANDS)}
        ms = {D: [] for D in fns}
        peak = {D: 0 for D in fns}
        for D, fn in fns.items():
            fn(frame)
        for _ in range(PAR_TURNS):
            for D, fn in fns.items():
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats(dev)
                e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                e0.record()
                fn(frame)
                e1.record()
                torch.cuda.synchronize()
                ms[D].append(e0.elapsed_time(e1))
                peak[D] = max(peak[D], torch.cuda.max_memory_allocated(dev) / 2**30)
    out.update(view_ms={D: sum(v) / len(v) for D, v in ms.items()}, view_ms_turns=ms, peak_gib=peak,
               instance_capacity={D: o.instance_capacity for D, o in band_opts.items()})
    log(f"[parallel] serving the bench frame in bands (instance_capacity {out['instance_capacity']}), "
        f"{PAR_TURNS} turns: ms/view "
        + ", ".join(f"D={D} {out['view_ms'][D]:.3f}" for D in ms) + "; peak GiB "
        + ", ".join(f"D={D} {peak[D]:.3f}" for D in peak))
    return {"errors": err, "launches": launches, "numbers": out}


def train_bands(dev) -> tuple:
    """11b: the bench train cell's step in 2 bands in turn against the
    whole-frame step on the same draws: loss (rtol 1e-5), gradients
    (grads_close), parameters after the step (params_close), radii and
    counts equal; kernels 2.2 and 2.4 against their plain versions on
    the band step's own inputs; ms/step at D = 1 and 2 in turns. Returns
    (the cell, the results)."""
    import dataclasses

    from street_gaussians_torch.ops import rasterize, segsum, tile_raster2
    from street_gaussians_torch.models import sky_cubemap
    from street_gaussians_torch.parallel import tiles
    from street_gaussians_torch.train_lib import flatten_params, make_lr_tree, take_draws

    cell = parallel_cell(dev)
    table, pose = cell.scene.table, cell.scene.pose_data
    # each band at the frame's capacity: the frame's split in two drops
    # instances (11a)
    band_step = tiles.make_tile_sharded_train_step(
        cell.cfg, table, pose, dataclasses.replace(cell.opts, instance_capacity=2 * cell.opts.instance_capacity), 2)
    draws = take_draws(table, cell.state, cell.frame.cam, torch.Generator(device=dev).manual_seed(1), cell.opts)
    whole = cell.step_fn.loss_and_grads(cell.state, cell.frame, cell.gt, draws=draws)
    recs = {"tile_blend_bwd": CallRecorder(tile_raster2.tile_blend_bwd, [tile_raster2]),
            "segment_rowsum": CallRecorder(segsum.segment_rowsum, [rasterize, sky_cubemap])}
    try:
        torch.cuda.synchronize()
        _zero_counts()
        band = band_step.loss_and_grads(cell.state, cell.frame, cell.gt, draws=draws)
        torch.cuda.synchronize()
        launches = _launch_counts()
    finally:
        for r in recs.values():
            r.restore()
    if (launches["tile_blend_instances"], launches["tile_blend_bwd"], launches["segment_rowsum"]) != (2, 2, 4):
        raise AssertionError(f"the bench step in 2 bands launched {launches}")
    if not torch.equal(band[1]["radii"], whole[1]["radii"]) or int(band[1]["overflow"]) + int(whole[1]["overflow"]):
        raise AssertionError(f"bench step in 2 bands: radii differ, or instances dropped (bands "
                             f"{int(band[1]['overflow'])}, whole frame {int(whole[1]['overflow'])})")
    lw, lb = float(whole[0]["loss"].detach()), float(band[0]["loss"].detach())
    if not math.isclose(lb, lw, rel_tol=1e-5):
        raise AssertionError(f"bench step loss in 2 bands {lb} vs whole frame {lw}")
    alive = cell.state.aux.alive.cpu().numpy()
    for k, g in whole[2].items():
        w = g.cpu().numpy()
        b = band[2][k].cpu().numpy()
        if k.startswith("gaussians."):
            m = alive.reshape((-1,) + (1,) * (w.ndim - 1))
            w, b = w * m, b * m
        if np.abs(w).max() > 0:
            grads_close(by_row(k, b), by_row(k, w), f"bench step in 2 bands: grad {k}")
    for i, name in ((3, "mean2d"), (4, "AbsGS")):
        grads_close(band[i].cpu().numpy(), whole[i].cpu().numpy(), f"bench step in 2 bands: grad {name}")
    g_ref = {k: v.cpu().numpy() for k, v in whole[2].items()}
    n_inst = int(whole[1]["num_instances"])
    del whole, band

    err = {"tile_blend_bwd": 0.0, "segment_rowsum": 0.0}
    with torch.no_grad():
        for args, kw in recs["tile_blend_bwd"].calls:
            payload, starts, counts, out, gout, F, gx, T = args
            err["tile_blend_bwd"] = max(err["tile_blend_bwd"], compare_blend_bwd(
                tile_raster2.tile_blend_bwd(*args, **kw), tile_raster2.tile_blend_bwd_plain(*args),
                live_lanes(payload, starts, counts), F, f"tile_blend_bwd on a band of the bench step ({T} tiles)"))
        for args, kw in recs["segment_rowsum"].calls:
            d, keys = args[0], args[1]
            N = kw["num_segments"]
            what = "payload" if N == cell.scene.table.capacity else "sky (the band's row window)"
            what = f"segment_rowsum on a band of the bench step, {what} (C={d.shape[0]}, L={d.shape[1]}, N={N})"
            got = segsum.segment_rowsum(d, keys, num_segments=N)
            err["segment_rowsum"] = max(err["segment_rowsum"], compare_segsum(
                got, segsum.segment_rowsum_plain(d, keys, num_segments=N),
                segsum.segment_rowsum_plain(d.abs(), keys, num_segments=N), what))
            check_emulated(got, d, keys, N, what)
    del recs

    s_whole, _ = cell.step_fn(cell.state, cell.frame, cell.gt, draws=draws)
    s_band, sc = band_step(cell.state, cell.frame, cell.gt, draws=draws)
    lr = {k: float(torch.as_tensor(v).max()) for k, v in
          make_lr_tree(cell.cfg, table, cell.state.params, cell.state.aux, cell.state.step).items()}
    pw, pb = flatten_params(s_whole.params), flatten_params(s_band.params)
    for k in pw:
        params_close(by_row(k, pb[k].cpu().numpy()), by_row(k, pw[k].cpu().numpy()), by_row(k, g_ref[k]), lr[k], 1,
                     f"bench step in 2 bands: {k}")
    if not torch.equal(s_band.aux.denom, s_whole.aux.denom):
        raise AssertionError("bench step in 2 bands: visibility counts differ")
    grads_close(s_band.aux.grad_accum.cpu().numpy(), s_whole.aux.grad_accum.cpu().numpy(),
                "bench step in 2 bands: grad_accum")
    log(f"[check] bench train step in 2 bands against the whole frame, same draws ({n_inst} instances): loss "
        f"{lb:.7f} vs {lw:.7f}; "
        f"gradients, parameters and statistics within grads_close / params_close; launches {launches}")
    del s_whole, s_band

    steps = {1: cell.step_fn, 2: band_step}
    gen = torch.Generator(device=dev).manual_seed(2)
    ms = {1: [], 2: []}
    state = cell.state
    for D, fn in steps.items():
        fn(state, cell.frame, cell.gt, gen)
    for _ in range(PAR_TURNS):
        for D, fn in steps.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(state, cell.frame, cell.gt, gen)
            torch.cuda.synchronize()
            ms[D].append(1e3 * (time.perf_counter() - t0))
    out = {"step_ms": {D: sum(v) / len(v) for D, v in ms.items()}, "step_ms_turns": ms}
    log(f"[parallel] bench train step, {PAR_TURNS} turns: ms/step D=1 {out['step_ms'][1]:.3f}, "
        f"D=2 {out['step_ms'][2]:.3f}")
    return cell, {"errors": err, "launches": {"train_D2": launches}, "numbers": out}


def camera_ranks(dev, cell, tmp) -> dict:
    """11c: two ranks on cuda:0 (Gloo: NCCL refuses two ranks on one
    card), one bench view each, one camera-parallel step in one band and
    in two: the ranks bit-equal, and the one-band step against the
    in-process reference (loss_and_grads of each view on the same draws,
    the gradients averaged, the statistics summed, one Adam step) by
    grads_close / params_close; the two-band step against the one-band
    one. Their ms/step: two ranks sharing one card, not a scaling
    figure."""
    from street_gaussians_torch.optim.adam import adam_update
    from street_gaussians_torch.optim.densify import add_stats, step_stats
    from street_gaussians_torch.train_lib import flatten_params, make_lr_tree, take_draws

    workdir = os.path.join(tmp, "ranks")
    os.makedirs(workdir)
    torch.multiprocessing.spawn(camera_rank, args=(2, workdir, {}), nprocs=2, join=True)
    ranks = [torch.load(os.path.join(workdir, f"rank{r}.pt"), weights_only=False) for r in range(2)]
    if _state_hash(cell.state) != ranks[0]["initial_hash"] or ranks[1]["initial_hash"] != ranks[0]["initial_hash"]:
        raise AssertionError("the ranks' initial states differ from the reference's")
    for D in (1, 2):
        a, b = (r["steps"][D] for r in ranks)
        if a["hash"] != b["hash"]:
            raise AssertionError(f"camera-parallel step ({D} band(s)): the ranks' states are not bit-equal")
        for r, x in enumerate((a, b)):
            n = x["launches"]
            if n["tile_blend_instances"] != D or n["tile_blend_bwd"] != D or n["segment_rowsum"] != 2 * D:
                raise AssertionError(f"rank {r}, {D} band(s): launches {n}")
            if x["overflow"] != 0:
                raise AssertionError(f"rank {r}, {D} band(s): overflow {x['overflow']}")

    # the in-process reference: both views' gradients averaged
    table, state = cell.scene.table, cell.state
    grads, stats, in_range, losses = [], [], [], []
    for b, v in enumerate(PAR_VIEWS):
        frame, gt = cell.scene.frames[v], view_gt(cell, v)
        draws = take_draws(table, state, frame.cam, torch.Generator(device=dev).manual_seed(0), cell.opts, 2, b)
        sc, out, g, g_m2d, g_abs = cell.step_fn.loss_and_grads(state, frame, gt, draws=draws)
        losses.append(float(sc["loss"].detach()))
        with torch.no_grad():
            grads.append(g)
            stats.append(step_stats(out["radii"], g_m2d, g_abs, frame.cam.W, frame.cam.H))
            mid = state.aux.model_id
            in_range.append((frame.cam.frame >= table.start_frame[mid]) & (frame.cam.frame <= table.end_frame[mid]))
    with torch.no_grad():
        g = {k: (grads[0][k] + grads[1][k]) / 2 for k in grads[0]}
        aux = add_stats(state.aux, stats[0][0] + stats[1][0], stats[0][1] + stats[1][1],
                        torch.maximum(stats[0][2], stats[1][2]))
        values = flatten_params(state.params)
        row_mask = aux.alive & (in_range[0] | in_range[1])
        lr = make_lr_tree(cell.cfg, table, state.params, aux, state.step)
        ref, _ = adam_update(values, g, state.adam, lr, {k: row_mask for k in values if k.startswith("gaussians.")})
    loss_ref = sum(losses) / 2
    got = ranks[0]["steps"][1]
    if not math.isclose(got["loss"], loss_ref, rel_tol=1e-5):
        raise AssertionError(f"camera-parallel loss {got['loss']} vs the reference's {loss_ref}")
    for k, v in ref.items():
        lr_k = float(torch.as_tensor(lr[k]).max())
        g_k = by_row(k, g[k].cpu().numpy())
        params_close(by_row(k, got["params"][k]), by_row(k, v.cpu().numpy()), g_k, lr_k, 1,
                     f"camera-parallel step: {k}")
        params_close(by_row(k, ranks[0]["steps"][2]["params"][k]), by_row(k, got["params"][k]), g_k, lr_k, 1,
                     f"camera-parallel step in 2 bands: {k}")
    if not np.array_equal(got["aux"]["denom"], aux.denom.cpu().numpy()):
        raise AssertionError("camera-parallel step: visibility counts differ from the reference's")
    if not np.array_equal(got["aux"]["max_radii"], aux.max_radii.cpu().numpy()):
        raise AssertionError("camera-parallel step: max radii differ from the reference's")
    grads_close(got["aux"]["grad_accum"], aux.grad_accum.cpu().numpy(), "camera-parallel step: grad_accum")
    out = {"step_ms": {D: [r["steps"][D]["ms"] for r in ranks] for D in (1, 2)},
           "launches": {f"rank{r}_D{D}": ranks[r]["steps"][D]["launches"] for r in range(2) for D in (1, 2)}}
    mean = {D: sum(sum(m) for m in out["step_ms"][D]) / (2 * PAR_TURNS) for D in (1, 2)}
    out["step_ms_mean"] = mean
    log(f"[parallel] camera-parallel step, 2 ranks on one card (Gloo), one bench view each: the ranks bit-equal; "
        f"loss {got['loss']:.7f} vs the in-process reference's {loss_ref:.7f}; parameters and statistics within "
        f"params_close / grads_close; in 2 bands within params_close of the one-band step. ms/step (two ranks "
        f"sharing one card, not a scaling figure): 1 band {mean[1]:.1f}, 2 bands {mean[2]:.1f}")
    return out


def runner_parallel(dev, root: str, tmp: str) -> dict:
    """11d: step 8's sequence (PAR_FRAMES frames of 3 cameras) through
    the CLIs: `train` at train.tile_shards 2 for PAR_ITERS iterations
    (in-process: the kernels' launches counted), the same under
    `torchrun --nproc_per_node 2` at train.batch_size 2 (rank 0 alone
    writes), and `render` with and without render.parallel tile=2 from
    the first run's checkpoint: the PNGs within 1 (u8), sky_downsample
    1."""
    import glob

    from street_gaussians_torch import render as render_cli
    from street_gaussians_torch import train as train_cli
    from street_gaussians_torch.utils.image_io import imread

    recipe = os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs", "example", "waymo_train_002.yaml")

    def opts(out):
        return ["source_path", root, "model_path", out, "data.selected_frames", f"[0, {PAR_FRAMES - 1}]",
                "data.use_tracker", "false", "train.iterations", str(PAR_ITERS), "train.test_iterations", "[]",
                "train.save_iterations", "[]", "train.checkpoint_iterations", f"[{PAR_ITERS}]",
                "render.instance_capacity", str(PAR_CAPACITY), "render.save_video", "false"]

    res = {}
    out_t = os.path.join(tmp, "par_tile")
    torch.cuda.synchronize()
    _zero_counts()
    t0 = time.perf_counter()
    final = train_cli.main(["--config", recipe, *opts(out_t), "train.tile_shards", "2"])
    torch.cuda.synchronize()
    res["tile_shards_s"] = time.perf_counter() - t0
    n = _launch_counts()
    res["tile_shards_launches"] = n
    if (n["tile_blend_instances"] < 2 * PAR_ITERS or n["tile_blend_bwd"] != 2 * PAR_ITERS
            or n["segment_rowsum"] != 4 * PAR_ITERS):
        raise AssertionError(f"train.tile_shards 2, {PAR_ITERS} iterations: launches {n}")
    with open(os.path.join(out_t, "record", "train_log.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    if len(recs) != 1 or not math.isfinite(recs[0]["loss"]) or recs[0]["overflow"] != 0:
        raise AssertionError(f"train.tile_shards 2: log {recs}")
    log(f"[parallel] train --config waymo_train_002.yaml train.tile_shards 2: {PAR_ITERS} iterations in "
        f"{res['tile_shards_s']:.1f} s, loss {recs[0]['loss']:.6f}, launches {n}")

    out_b = os.path.join(tmp, "par_batch")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "2",
           "-m", "street_gaussians_torch.train", "--config", recipe, *opts(out_b), "train.batch_size", "2"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                          cwd=os.path.dirname(os.path.abspath(__file__)))
    res["torchrun_s"] = time.perf_counter() - t0
    lines = [ln for ln in (proc.stdout + proc.stderr).splitlines() if ln.startswith(("[comm]", "[dp]", "[eval"))]
    for ln in lines:
        log(f"[parallel] torchrun: {ln}")
    if proc.returncode != 0:
        raise AssertionError(f"torchrun train.batch_size 2 failed ({proc.returncode}):\n{proc.stderr[-4000:]}")
    with open(os.path.join(out_b, "record", "train_log.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    if len(recs) != 1 or not math.isfinite(recs[0]["loss"]) or recs[0]["overflow"] != 0:
        raise AssertionError(f"torchrun train.batch_size 2: the log holds {recs} (one record from rank 0 expected)")
    if not os.path.isdir(os.path.join(out_b, "trained_model", f"iteration_{PAR_ITERS}")):
        raise AssertionError("torchrun train.batch_size 2: no checkpoint")
    log(f"[parallel] torchrun --nproc_per_node 2 train train.batch_size 2: {PAR_ITERS} iterations, "
        f"{res['torchrun_s']:.1f} s wall (two processes on one card); one log, loss {recs[0]['loss']:.6f}")

    pngs = {}
    for par in ("", "tile=2"):
        _zero_counts()
        render_cli.main(["--config", recipe, *opts(out_t), *(["render.parallel", par] if par else [])])
        n = _launch_counts()
        d = os.path.join(out_t, "train_renders")
        pngs[par] = {os.path.basename(p): imread(p).astype(int) for p in sorted(glob.glob(os.path.join(d, "*.png")))}
        shutil.move(d, d + (par.replace("=", "") or "_whole"))
        res[f"render_launches_{par or 'whole'}"] = n
        if n["tile_blend_instances"] < (2 if par else 1) * len(pngs[par]):
            raise AssertionError(f"render {par}: launches {n} for {len(pngs[par])} views")
    if list(pngs[""]) != list(pngs["tile=2"]) or len(pngs[""]) != 3 * PAR_FRAMES:
        raise AssertionError(f"render: {len(pngs[''])} and {len(pngs['tile=2'])} PNGs")
    worst = max(int(np.abs(pngs[""][k] - pngs["tile=2"][k]).max()) for k in pngs[""])
    if worst > 1:
        raise AssertionError(f"render.parallel tile=2: PNGs differ by {worst} from those rendered without it")
    log(f"[parallel] render with and without render.parallel tile=2: {len(pngs[''])} PNGs each, within {worst} "
        "(u8); launches " + json.dumps({k: v for k, v in res.items() if k.startswith("render_launches")}))
    res["final_param_checksum"] = final["param_checksum"]
    return res


def parallel_phase(dev, scene, params, root: str, tmp: str, smi: str) -> dict:
    """Step 11 (see serve_bands, train_bands, camera_ranks and
    runner_parallel). Returns the kernels' errors and launches on the
    band paths and the numbers printed."""
    t0 = time.perf_counter()
    a = serve_bands(dev, scene, params)
    torch.cuda.empty_cache()
    cell, b = train_bands(dev)
    torch.cuda.empty_cache()
    c = camera_ranks(dev, cell, tmp)
    del cell
    torch.cuda.empty_cache()
    d = runner_parallel(dev, root, tmp)
    numbers = {"card": smi, "serve": a["numbers"], "train": b["numbers"], "camera_ranks": c, "runner": d,
               "seconds": time.perf_counter() - t0}
    log(f"[parallel] step 11 in {numbers['seconds']:.1f} s ({smi})")
    return {"errors": {**a["errors"], **b["errors"]},
            "launches": {"serve": a["launches"], **b["launches"], **c["launches"],
                         "runner_tile_shards": d["tile_shards_launches"]},
            "numbers": numbers}


# ---- step 12: Gaussian-sharded rendering and training, multi-host ----
GAUSS_SERVE = (("gauss=2", 2, 1), ("gauss=4", 4, 1), ("gausstile=2x2", 2, 2))  # (name, row blocks, bands)
GAUSS_ITERS = 12  # the gauss runner: densify at 10 (from 5, every 10), a checkpoint at 12
GAUSS_RESUME_ITERS = 14
IMAGE_KEYS = ("rgb", "depth", "acc", "T")
COUNTS = ("num_instances", "overflow", "overflow_instance", "overflow_tile")


def serve_gauss(dev, scene, params) -> dict:
    """12a: the bench frame through gauss=2, gauss=4 (the table's rows
    composed in 2 and 4 blocks in turn, joined) and gausstile=2x2 (2
    blocks, the joined screen in 2 tile-row bands, each at a capacity
    from its demand as 11a) in one process, against the whole frame:
    radii and the integer outputs equal, the images bit-equal (gauss=N)
    or to the blend tolerances (gausstile; at sky_downsample 2 but on the
    band-edge rows, as 11a); kernels 2.1 and 2.3 against their plain
    versions on the gauss=4 render's own inputs; ms/view and peak memory
    in turns with the whole frame."""
    import dataclasses

    from street_gaussians_torch import serve
    from street_gaussians_torch.models.renderer import render_frame, screen_space
    from street_gaussians_torch.models.sky_cubemap import build_sky_table
    from street_gaussians_torch.ops import fill, tile_raster2
    from street_gaussians_torch.ops.preprocess import clip_screen_to_rows
    from street_gaussians_torch.parallel import gauss, tiles

    frame = scene.frames[0]
    H = frame.cam.H
    opts = serve.SERVE_OPTS
    with torch.no_grad():
        sky_table = build_sky_table(params.sky.cubemap)
        screen, _ = screen_space(params, scene.aux, scene.table, scene.pose_data, frame, serve.SERVE_STEP, opts)
        lay = tiles.band_layout(H, 2)
        need = max(int(clip_screen_to_rows(screen, *lay.band(d)).tiles_touched.sum()) for d in range(2))
        del screen
    fns = {"whole": lambda f: render_frame(params, scene.aux, scene.table, scene.pose_data, f, serve.SERVE_STEP,
                                           opts=opts, sky_table=sky_table)}
    for name, G, T in GAUSS_SERVE:
        o = opts if T == 1 else dataclasses.replace(opts, instance_capacity=T * _round_up(need, 128))
        r = gauss.make_gauss_sharded_render(scene.table, scene.pose_data, o, G, tile_shards=T)
        fns[name] = (lambda r: lambda f: r(params, scene.aux, f, sky_table=sky_table))(r)
    launches, err = {}, {"expand_runs": 0.0, "tile_blend_instances": 0.0}
    with torch.no_grad():
        whole = fns["whole"](frame)
        for name, G, T in GAUSS_SERVE:
            torch.cuda.synchronize()
            _zero_counts()
            got = fns[name](frame)
            torch.cuda.synchronize()
            n = launches[name] = _launch_counts()
            if n["tile_blend_instances"] != T or n["expand_runs"] < T:
                raise AssertionError(f"{name}: a view launched {n}")
            counts = {k: (int(got[k]), int(whole[k])) for k in COUNTS}
            if any(a != b for a, b in counts.values()) or not torch.equal(got["radii"], whole["radii"]):
                raise AssertionError(f"{name}: radii or counts {counts} differ from the whole frame's")
            if int(whole["overflow"]) != 0:
                raise AssertionError(f"the whole bench frame drops {int(whole['overflow'])} instances")
            what = f"bench frame through {name} against the whole frame"
            if T == 1:
                same = [k for k in IMAGE_KEYS if torch.equal(got[k], whole[k])]
                e = compare_frames(got, whole, what)
                log(f"[gauss] {what}: radii and {list(COUNTS)} equal; {same} bit-equal; max abs err {e:.3e}")
            else:
                edges = band_edge_rows(H, T)
                keep = torch.ones(H, dtype=torch.bool, device=dev)
                keep[edges] = False
                e = compare_frames(got, whole, f"{what}, rows {edges} left out", keep)
                log(f"[gauss] {what}: radii and counts equal; max abs err {e:.3e} but on the band-edge rows {edges} "
                    "(the reference's own upsample, 11a)")
        # kernels 2.1 and 2.3 on the gauss=4 render's own inputs
        recs = {"expand_runs": CallRecorder(fill.expand_runs, [fill]),
                "forward": CallRecorder(tile_raster2._forward, [tile_raster2])}
        try:
            fns["gauss=4"](frame)
        finally:
            for r in recs.values():
                r.restore()
        for a_args, _ in recs["expand_runs"].calls:
            if not torch.equal(fill.expand_runs(*a_args), fill.expand_runs_plain(*a_args)):
                raise AssertionError("expand_runs kernel != plain on the gauss=4 render's inputs")
        for b_args, _ in recs["forward"].calls:
            err["tile_blend_instances"] = max(err["tile_blend_instances"], compare_blend(
                tile_raster2.tile_blend_instances(*b_args), tile_raster2.tile_blend_plain(*b_args), b_args[3],
                f"tile_blend on the gauss=4 render's inputs ({b_args[5]} tiles, {int(b_args[2].sum())} instances)"))
        log("[check] expand_runs on the gauss=4 render's own inputs: exact")
        del recs, whole, got

        ms = {k: [] for k in fns}
        peak = {k: 0.0 for k in fns}
        for fn in fns.values():
            fn(frame)
        for _ in range(PAR_TURNS):
            for k, fn in fns.items():
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats(dev)
                e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                e0.record()
                fn(frame)
                e1.record()
                torch.cuda.synchronize()
                ms[k].append(e0.elapsed_time(e1))
                peak[k] = max(peak[k], torch.cuda.max_memory_allocated(dev) / 2**30)
    out = {"view_ms": {k: sum(v) / len(v) for k, v in ms.items()}, "view_ms_turns": ms, "peak_gib": peak,
           "gausstile_band_capacity": _round_up(need, 128)}
    log(f"[gauss] serving the bench frame, {PAR_TURNS} turns: ms/view "
        + ", ".join(f"{k} {v:.3f}" for k, v in out["view_ms"].items()) + "; peak GiB "
        + ", ".join(f"{k} {v:.3f}" for k, v in peak.items()))
    return {"errors": err, "launches": launches, "numbers": out}


def _tensors_hash(tensors: dict) -> str:
    import hashlib

    h = hashlib.sha256()
    for k, v in sorted(tensors.items()):
        h.update(k.encode())
        h.update(v.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def gauss_rank(rank: int, world: int, workdir: str) -> None:
    """Step 12b's rank (torch.multiprocessing.spawn): a Gloo group of
    `world` ranks on cuda:0; step 11's bench train cell, rank 0's state
    on every rank, this rank's block of its rows (the bytes the copy
    takes by torch.cuda.memory_allocated); the gauss step's gradients on
    the whole table's draws, the whole frame and in 2 bands in turn
    (gauss x tile), their launches and the bytes each collective took;
    one step's state gathered; timed steps. Saves its results and (rank
    0) the gradients, gathered to the whole table's rows."""
    import dataclasses

    from street_gaussians_torch.parallel import comm, dp, gauss
    from street_gaussians_torch.train_lib import GAUSS, flatten_params, take_draws

    group = comm.init_group(rank, world, "file://" + os.path.join(workdir, "rendezvous"), device="cuda:0")
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        dev = group.device
        cell = parallel_cell(dev)
        whole = dp.broadcast_state(cell.state, group)
        table, pose = cell.scene.table, cell.scene.pose_data
        torch.cuda.synchronize()
        m0 = torch.cuda.memory_allocated(dev)
        state = gauss.shard_train_state(whole, rank, world)
        torch.cuda.synchronize()
        res = {"initial_hash": _state_hash(whole), "local_bytes_allocated": torch.cuda.memory_allocated(dev) - m0,
               "local_bytes": gauss.row_state_bytes(state), "whole_bytes": gauss.row_state_bytes(whole),
               "steps": {}}
        del whole
        cell.state = None
        torch.cuda.empty_cache()
        draws = take_draws(table, state, cell.frame.cam, torch.Generator(device=dev).manual_seed(0), cell.opts,
                           model_id=gauss.model_ids(table))
        for T in (1, 2):
            # each band at the frame's capacity (11a)
            opts = dataclasses.replace(cell.opts, instance_capacity=T * cell.opts.instance_capacity)
            step = gauss.make_gauss_sharded_train_step(cell.cfg, table, pose, opts, world, group=group, tile_shards=T)
            torch.cuda.synchronize()
            _zero_counts()
            group.traffic.clear()
            sc, out, g, g_m2d, g_abs = step.loss_and_grads(state, cell.frame, cell.gt, draws=draws)
            torch.cuda.synchronize()
            entry = {"launches": _launch_counts(), "traffic": dict(group.traffic), "loss": float(sc["loss"].detach()),
                     "overflow": int(out["overflow"]), "num_instances": int(out["num_instances"])}
            names = [k for k in g if k.startswith(GAUSS)]
            with torch.no_grad():
                rows = group.gather_rows_many([x.detach() for x in [*(g[k] for k in names), g_m2d, g_abs,
                                                                    out["radii"]]])
            grads = {**g, **dict(zip(names, rows))}
            entry["replicated_grad_hash"] = _tensors_hash({k: v for k, v in g.items() if k not in names})
            if rank == 0:
                entry["grads"] = _numpy(grads)
                entry["m2d"], entry["abs"], entry["radii"] = (x.cpu().numpy() for x in rows[-3:])
            del g, grads, rows
            s1, _ = step(state, cell.frame, cell.gt, draws=draws)
            entry["step_hash"] = _state_hash(gauss.gather_train_state(s1, step.shards))
            entry["replicated_hash"] = _tensors_hash({k: v for k, v in flatten_params(s1.params).items()
                                                      if not k.startswith(GAUSS)})
            gen = torch.Generator(device=dev).manual_seed(1)
            ms, s = [], s1
            for _ in range(PAR_TURNS):
                torch.distributed.barrier()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                s, _ = step(s, cell.frame, cell.gt, gen)
                torch.cuda.synchronize()
                ms.append(1e3 * (time.perf_counter() - t0))
            entry["ms"] = ms
            del s, s1
            res["steps"][T] = entry
        res["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
        torch.save(res, os.path.join(workdir, f"rank{rank}.pt"))
    finally:
        comm.close_group()


def gauss_ranks(dev, tmp) -> dict:
    """12b: two gauss ranks on cuda:0 over Gloo, the bench train step on
    the whole table's draws: the loss against the in-process single
    step's within 1e-6 relative, every gradient leaf (the whole table's
    rows gathered) within grads_close, the radii equal; the gauss x tile
    step (2 bands in turn a rank) within rtol 1e-5 and grads_close; the
    ranks' replicated leaves and their steps' whole states bit-equal;
    each rank's row state about half the whole's; the bytes the
    collectives took; ms/step of the two ranks sharing one card and of
    the single step, in turn."""
    import dataclasses

    from street_gaussians_torch.train_lib import take_draws

    workdir = os.path.join(tmp, "gauss_ranks")
    os.makedirs(workdir)
    torch.multiprocessing.spawn(gauss_rank, args=(2, workdir), nprocs=2, join=True)
    ranks = [torch.load(os.path.join(workdir, f"rank{r}.pt"), weights_only=False) for r in range(2)]
    cell = parallel_cell(dev)
    if _state_hash(cell.state) != ranks[0]["initial_hash"] or ranks[1]["initial_hash"] != ranks[0]["initial_hash"]:
        raise AssertionError("the gauss ranks' initial states differ from the reference's")
    draws = take_draws(cell.scene.table, cell.state, cell.frame.cam, torch.Generator(device=dev).manual_seed(0),
                       cell.opts)
    sc, out, g, g_m2d, g_abs = cell.step_fn.loss_and_grads(cell.state, cell.frame, cell.gt, draws=draws)
    loss = float(sc["loss"].detach())
    alive = cell.state.aux.alive.cpu().numpy()
    ref = {k: v.cpu().numpy() for k, v in g.items()}
    radii = out["radii"].detach().cpu().numpy()
    m2d, absg = g_m2d.cpu().numpy(), g_abs.cpu().numpy()
    del sc, out, g, g_m2d, g_abs
    res = {}
    for T in (1, 2):
        a, b = (r["steps"][T] for r in ranks)
        what = f"gauss step over 2 ranks{' x 2 bands in turn' if T == 2 else ''}"
        for key in ("step_hash", "replicated_hash", "replicated_grad_hash", "loss"):
            if a[key] != b[key]:
                raise AssertionError(f"{what}: the ranks' {key} differ")
        for r, x in enumerate((a, b)):
            n = x["launches"]
            if n["tile_blend_instances"] != T or n["tile_blend_bwd"] != T or n["segment_rowsum"] != 2 * T:
                raise AssertionError(f"{what}, rank {r}: launches {n}")
            if x["overflow"] != 0:
                raise AssertionError(f"{what}, rank {r}: overflow {x['overflow']}")
        rel = abs(a["loss"] - loss) / abs(loss)
        if rel > (1e-6 if T == 1 else 1e-5):
            raise AssertionError(f"{what}: loss {a['loss']} vs the single step's {loss} (rel {rel:.2e})")
        if not np.array_equal(a["radii"], radii):
            raise AssertionError(f"{what}: radii differ from the single step's")
        for k, w in ref.items():
            got = a["grads"][k]
            if k.startswith("gaussians."):
                m = alive.reshape((-1,) + (1,) * (w.ndim - 1))
                w, got = w * m, got * m
            if np.abs(w).max() > 0:
                grads_close(by_row(k, got), by_row(k, w), f"{what}: grad {k}")
        grads_close(a["m2d"], m2d, f"{what}: grad mean2d")
        grads_close(a["abs"], absg, f"{what}: grad AbsGS")
        res[T] = {"loss": a["loss"], "loss_rel": rel, "ms": [x["ms"] for x in (a, b)],
                  "step_ms_mean": sum(sum(x["ms"]) for x in (a, b)) / (2 * PAR_TURNS),
                  "traffic_bytes": a["traffic"], "launches": [x["launches"] for x in (a, b)]}
        log(f"[gauss] {what} on one card (Gloo), the bench step on the single step's draws: loss {a['loss']:.8f} vs "
            f"{loss:.8f} (rel {rel:.2e}); gradients within grads_close, radii equal; the ranks' whole states and "
            f"replicated leaves bit-equal; bytes into each collective a step {a['traffic']}; launches "
            f"{a['launches']}; ms/step {res[T]['step_ms_mean']:.1f}")
    del ref
    # the single step in this process, for the time beside the ranks'
    gen = torch.Generator(device=dev).manual_seed(1)
    cell.step_fn(cell.state, cell.frame, cell.gt, gen)
    single_ms = []
    for _ in range(PAR_TURNS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cell.step_fn(cell.state, cell.frame, cell.gt, gen)
        torch.cuda.synchronize()
        single_ms.append(1e3 * (time.perf_counter() - t0))
    r0 = ranks[0]
    res.update(single_ms=single_ms, local_bytes=[r["local_bytes"] for r in ranks],
               local_bytes_allocated=[r["local_bytes_allocated"] for r in ranks], whole_bytes=r0["whole_bytes"],
               peak_gib=[r["peak_gib"] for r in ranks])
    share = [r["local_bytes_allocated"] / r0["whole_bytes"] for r in ranks]
    if any(abs(x - 0.5) > 0.01 for x in share):
        raise AssertionError(f"the ranks' row state is {share} of the whole's")
    log(f"[gauss] row state (parameters, Adam, aux) a rank by torch.cuda.memory_allocated: "
        f"{res['local_bytes_allocated']} bytes, {share} of the whole's {r0['whole_bytes']}; the single step "
        f"{sum(single_ms) / len(single_ms):.1f} ms/step in this process; peak GiB a rank {res['peak_gib']}")
    res["launches"] = {f"rank{r}_T{T}": ranks[r]["steps"][T]["launches"] for r in range(2) for T in (1, 2)}
    del cell
    return res


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _finals(text: str) -> list:
    """The `[train] final {...}` records of a run's output, each decoded
    where it starts: the ranks of one torchrun share its output, so a
    record need not be the only thing on its line."""
    dec = json.JSONDecoder()
    return [dec.raw_decode(text, m.end())[0] for m in re.finditer(r"\[train\] final ", text)]


def runner_gauss(dev, root: str, tmp: str) -> dict:
    """12c: step 8's sequence (PAR_FRAMES frames of 3 cameras) through the
    CLIs: `torchrun --nproc_per_node 2 ... train.gauss_shards 2` for
    GAUSS_ITERS iterations past a densify (at 10) and a checkpoint (at
    12), then a resume to GAUSS_RESUME_ITERS; `render` from the first
    run's checkpoint with and without render.parallel gauss=2 (in-process:
    the kernels' launches counted; the PNGs within 1, u8); two torchrun
    launches as two hosts of one rank (--nnodes 2 --node_rank 0|1,
    --master_addr 127.0.0.1) at train.multihost true train.batch_size 2:
    each host's own views, equal param_checksum, one log and one
    checkpoint."""
    import glob

    from street_gaussians_torch import render as render_cli
    from street_gaussians_torch.utils.image_io import imread

    here = os.path.dirname(os.path.abspath(__file__))
    recipe = os.path.join(here, "configs", "example", "waymo_train_002.yaml")

    def opts(out, iters):
        return ["source_path", root, "model_path", out, "data.selected_frames", f"[0, {PAR_FRAMES - 1}]",
                "data.use_tracker", "false", "train.iterations", str(iters), "train.test_iterations", "[]",
                "train.save_iterations", f"[{GAUSS_ITERS}]", "train.checkpoint_iterations", f"[{GAUSS_ITERS}]",
                "optim.densify_from_iter", "5", "optim.densification_interval", "10",
                "render.instance_capacity", str(PAR_CAPACITY), "render.save_video", "false"]

    def torchrun(args, what):
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "torch.distributed.run", *args], capture_output=True,
                              text=True, timeout=600, cwd=here)
        text = proc.stdout + proc.stderr
        for ln in text.splitlines():
            if ln.startswith(("[comm]", "[gauss]", "[resume]", "[train] final")):
                log(f"[gauss] {what}: {ln}")
        if proc.returncode != 0:
            raise AssertionError(f"{what} failed ({proc.returncode}):\n{proc.stderr[-4000:]}")
        return text, time.perf_counter() - t0

    res = {}
    out_g = os.path.join(tmp, "gauss_run")
    launch = ["--standalone", "--nproc_per_node", "2", "-m", "street_gaussians_torch.train", "--config", recipe]
    text, res["torchrun_s"] = torchrun([*launch, *opts(out_g, GAUSS_ITERS), "train.gauss_shards", "2"],
                                       "torchrun train.gauss_shards 2")
    finals = _finals(text)
    with open(os.path.join(out_g, "record", "train_log.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    dens = [r for r in recs if any(k.startswith("densify/") for k in r)]
    if (len(finals) != 2 or finals[0]["param_checksum"] != finals[1]["param_checksum"]
            or [r["iteration"] for r in dens] != [10] or len(recs) != 2 or recs[1]["overflow"] != 0
            or not os.path.isdir(os.path.join(out_g, "trained_model", f"iteration_{GAUSS_ITERS}"))):
        raise AssertionError(f"torchrun train.gauss_shards 2: finals {finals}, log {recs}")
    res["checksum"] = finals[0]["param_checksum"]
    res["densify"] = dens[0]
    text, res["resume_s"] = torchrun([*launch, *opts(out_g, GAUSS_RESUME_ITERS), "train.gauss_shards", "2"],
                                     "torchrun train.gauss_shards 2, resumed")
    finals = _finals(text)
    if len(finals) != 2 or {f["start_iteration"] for f in finals} != {GAUSS_ITERS} or \
            finals[0]["param_checksum"] != finals[1]["param_checksum"]:
        raise AssertionError(f"the gauss resume: finals {finals}")
    res["resume_checksum"] = finals[0]["param_checksum"]
    log(f"[gauss] torchrun --nproc_per_node 2 train.gauss_shards 2: {GAUSS_ITERS} iterations in "
        f"{res['torchrun_s']:.1f} s wall (two processes on one card), densify at 10 {dens[0]}, a checkpoint at "
        f"{GAUSS_ITERS}, the ranks' param_checksum equal ({res['checksum']}); resumed to {GAUSS_RESUME_ITERS} in "
        f"{res['resume_s']:.1f} s")

    pngs = {}
    for par in ("", "gauss=2"):
        _zero_counts()
        render_cli.main(["--config", recipe, *opts(out_g, GAUSS_ITERS), *(["render.parallel", par] if par else [])])
        n = _launch_counts()
        d = os.path.join(out_g, "train_renders")
        pngs[par] = {os.path.basename(p): imread(p).astype(int) for p in sorted(glob.glob(os.path.join(d, "*.png")))}
        shutil.move(d, d + (par.replace("=", "") or "_whole"))
        res[f"render_launches_{par or 'whole'}"] = n
        if n["tile_blend_instances"] < len(pngs[par]):
            raise AssertionError(f"render {par}: launches {n} for {len(pngs[par])} views")
    if list(pngs[""]) != list(pngs["gauss=2"]) or len(pngs[""]) != 3 * PAR_FRAMES:
        raise AssertionError(f"render: {len(pngs[''])} and {len(pngs['gauss=2'])} PNGs")
    worst = max(int(np.abs(pngs[""][k] - pngs["gauss=2"][k]).max()) for k in pngs[""])
    if worst > 1:
        raise AssertionError(f"render.parallel gauss=2: PNGs differ by {worst} from those rendered without it")
    log(f"[gauss] render from the sharded run's checkpoint with and without render.parallel gauss=2: "
        f"{len(pngs[''])} PNGs each, within {worst} (u8)")

    out_h = os.path.join(tmp, "hosts_run")
    port = _free_port()
    procs, t0 = [], time.perf_counter()
    for node in (0, 1):
        cmd = [sys.executable, "-m", "torch.distributed.run", "--nnodes", "2", "--node_rank", str(node),
               "--nproc_per_node", "1", "--master_addr", "127.0.0.1", "--master_port", str(port),
               "-m", "street_gaussians_torch.train", "--config", recipe, *opts(out_h, GAUSS_ITERS),
               "train.multihost", "true", "train.batch_size", "2"]
        procs.append(subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=here))
    outs = []
    try:
        for p in procs:
            so, se = p.communicate(timeout=600)
            outs.append((p.returncode, so + se))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    res["hosts_s"] = time.perf_counter() - t0
    finals = []
    for node, (rc, text) in enumerate(outs):
        for ln in text.splitlines():
            if ln.startswith(("[comm]", "[dp]", "[multihost]")):
                log(f"[gauss] two hosts, host {node}: {ln}")
        if rc != 0:
            raise AssertionError(f"two hosts, host {node} failed ({rc}):\n{text[-4000:]}")
        finals += _finals(text)
    with open(os.path.join(out_h, "record", "train_log.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    views = [set(f["host_views"]["first_epoch"]) for f in finals]
    if (len(finals) != 2 or finals[0]["param_checksum"] != finals[1]["param_checksum"] or views[0] & views[1]
            or len([r for r in recs if "loss" in r]) != 1
            or not os.path.isdir(os.path.join(out_h, "trained_model", f"iteration_{GAUSS_ITERS}"))):
        raise AssertionError(f"two hosts: finals {finals}, log {recs}")
    res["hosts_checksums"] = [f["param_checksum"] for f in finals]
    res["hosts_views"] = [f["host_views"] for f in finals]
    log(f"[gauss] two hosts (torchrun --nnodes 2, one rank each, one card) at train.multihost true "
        f"train.batch_size 2: {GAUSS_ITERS} iterations in {res['hosts_s']:.1f} s wall; host views "
        f"{[sorted(v) for v in views]}; param_checksum {res['hosts_checksums']} (equal); one log, one checkpoint")
    return res


def gauss_phase(dev, scene, params, root: str, tmp: str, smi: str) -> dict:
    """Step 12 (see serve_gauss, gauss_ranks and runner_gauss). Returns
    the kernels' errors and launches on the gauss paths and the numbers
    printed."""
    t0 = time.perf_counter()
    a = serve_gauss(dev, scene, params)
    torch.cuda.empty_cache()
    b = gauss_ranks(dev, tmp)
    torch.cuda.empty_cache()
    c = runner_gauss(dev, root, tmp)
    numbers = {"card": smi, "serve": a["numbers"], "train": {k: v for k, v in b.items() if k != "launches"},
               "runner": c, "seconds": time.perf_counter() - t0}
    log(f"[gauss] step 12 in {numbers['seconds']:.1f} s ({smi})")
    return {"errors": a["errors"],
            "launches": {"serve": a["launches"], **b["launches"],
                         **{k: v for k, v in c.items() if k.startswith("render_launches")}},
            "numbers": numbers}


# ---- step 13: the per-pixel oracle, the demo scene's convergence, make_ply ----
ORACLE_HW = (128, 192)
ORACLE_N = 2_000
# tests/test_rasterizer.py:131-145: the tile path against the oracle
ORACLE_TOL = {"rgb": 2e-5, "depth": 2e-4, "acc": 2e-5}
ORACLE_TOL_OPAQUE = {"rgb": 5e-5, "acc": 5e-5}  # opacities up to 0.999: the early-stop path
ORACLE_GRAD_ATOL = 1e-4  # test_gradient_parity: each leaf scaled by its largest |oracle value|
DEMO_FRAMES = 8
DEMO_ITERS = 2_000  # configs/demo_synthetic.yaml's own iterations: never cut
DEMO_MIN_PSNR = 28.0
DEMO_MIN_GAIN = 2.0  # train_psnr at DEMO_ITERS against its value at 500
# the JAX package's demo-scene train PSNRs at 500 / 1,000 / 2,000 (BASELINE.md:55-56)
JAX_DEMO_PSNR = {"jax_cpu_exact": (25.2, 26.8, 32.1), "jax_tpu": (27.7, 30.7, 47.9)}


def oracle_case(seed: int, n: int, H: int, W: int, dev, opacity_max: float = 0.9, spread: float = 1.2):
    """tests/test_rasterizer.make_scene's random Gaussians in front of a
    pinhole camera (focal 60 at 64 pixels wide, scaled with W), drawn by
    numpy: (cam, means, scales, quats, opacity, shs [n, 16, 3])."""
    from street_gaussians_torch.utils.camera import make_camera

    rng = np.random.default_rng(seed)
    focal = 60.0 * W / 64
    K = np.array([[focal, 0, W / 2], [0, focal, H / 2], [0, 0, 1]], np.float32)
    cam = make_camera(K, np.eye(4, dtype=np.float32), H, W, device=dev)
    means = np.stack([rng.uniform(-spread, spread, n), rng.uniform(-spread, spread, n), rng.uniform(1.0, 6.0, n)],
                     axis=-1)
    scales = rng.uniform(0.02, 0.15, (n, 3))
    quats = rng.normal(size=(n, 4))
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    opacity = rng.uniform(0.2, opacity_max, n)
    shs = rng.normal(size=(n, 16, 3)) * 0.3
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)  # noqa: E731
    return cam, t(means), t(scales), t(quats), t(opacity), t(shs)


def oracle_screen(cam, means, scales, quats, opacity, shs, sh_degree: int = 2, colors_precomp=None):
    from street_gaussians_torch.ops.preprocess import preprocess_gaussians

    return preprocess_gaussians(means, scales, quats, opacity, shs, cam.w2c, cam.full_proj, cam.cam_center,
                                cam.H, cam.W, cam.focal_x, cam.focal_y, cam.tan_fovx, cam.tan_fovy,
                                sh_degree=sh_degree, colors_precomp=colors_precomp)


def compare_oracle(got: dict, ref: dict, tol: dict, what: str) -> float:
    """The tile path's images against the oracle's: every pixel within
    tol, but where the two orders of f32 sums flip which Gaussian stops
    the pixel: at most max(1, B_FLIP_FRACTION * pixels) pixels, each
    within B_FLIP_TOL * max(1, max |oracle|). Returns the max abs error."""
    worst = 0.0
    for k, t in tol.items():
        if not torch.isfinite(got[k]).all():
            raise AssertionError(f"{what}: non-finite {k}")
        d = (got[k] - ref[k]).abs()
        d = d.amax(dim=-1) if d.dim() == 3 else d
        n_off, n_pix = int((d > t).sum()), d.numel()
        err = float(d.max())
        worst = max(worst, err)
        log(f"[oracle] {what} {k}: max_abs_err {err:.3e}; pixels beyond {t}: {n_off} of {n_pix}")
        if n_off > max(1, B_FLIP_FRACTION * n_pix) or err > B_FLIP_TOL * max(1.0, float(ref[k].abs().max())):
            raise AssertionError(f"{what} {k}: the tile path disagrees with the oracle")
    return worst


def compare_oracle_grads(got: dict, ref: dict, what: str) -> float:
    """Gradients of the tile path against the oracle's autograd, each
    leaf scaled by its largest |oracle value|: within ORACLE_GRAD_ATOL on
    all but max(1, BWD_FLIP_LANES * rows) Gaussians (a termination flip
    moves the Gaussians of its pixel), none beyond BWD_FLIP_TOL. Returns
    the largest scaled error."""
    worst = 0.0
    for name in ref:
        r, g = ref[name], got[name]
        if not torch.isfinite(g).all():
            raise AssertionError(f"{what}: non-finite gradient of {name}")
        scale = max(float(r.abs().max()), 1e-30)
        d = ((g - r).abs() / scale).reshape(r.shape[0], -1).amax(dim=1)
        off, err = int((d > ORACLE_GRAD_ATOL).sum()), float(d.max())
        worst = max(worst, err)
        log(f"[oracle] {what} d/d{name}: max scaled err {err:.3e}; rows beyond {ORACLE_GRAD_ATOL}: {off} of "
            f"{r.shape[0]}")
        if off > max(1, BWD_FLIP_LANES * r.shape[0]) or err > BWD_FLIP_TOL:
            raise AssertionError(f"{what} d/d{name}: the tile path's gradient disagrees with the oracle's")
    return worst


def oracle_phase(dev, H: int = ORACLE_HW[0], W: int = ORACLE_HW[1], n: int = ORACLE_N) -> dict:
    """13a: rasterize (kernels 2.1 and 2.3) against the per-pixel oracle
    (ops.rasterize.render_reference) on a random and a high-opacity scene
    of n Gaussians at H x W; the gradients of test_gradient_parity's loss
    (kernels 2.2 and 2.4) against the oracle's autograd; render_gaussians
    with colors_precomp and with shs through kernel 2.1, against the
    oracle. Returns the kernels' launches, the errors and seconds."""
    from street_gaussians_torch.models.simple_renderer import render_gaussians
    from street_gaussians_torch.ops.rasterize import RasterizeConfig, rasterize, render_reference

    t0 = time.perf_counter()
    cfg = RasterizeConfig(tile_capacity=2**20, instance_capacity=2**20)  # uncapped: nothing dropped
    _zero_counts()
    res = {"errors": {}}
    for name, seed, op_max, tol in (("random", 0, 0.9, ORACLE_TOL), ("opaque", 1, 0.999, ORACLE_TOL_OPAQUE)):
        cam, *g = oracle_case(seed, n, H, W, dev, opacity_max=op_max)
        bg = torch.tensor([0.1, 0.2, 0.3], device=dev) if name == "random" else torch.zeros(3, device=dev)
        with torch.no_grad():
            screen = oracle_screen(cam, *g)
            out = rasterize(screen, H, W, bg, config=cfg)
            ref = render_reference(screen, H, W, bg)
        if int(out["overflow"]) != 0:
            raise AssertionError(f"oracle {name}: {int(out['overflow'])} instances dropped")
        res["errors"][f"forward_{name}"] = compare_oracle(out, ref, tol, f"{name} scene ({n} Gaussians, {H}x{W})")

    # gradients of test_gradient_parity's loss (every output head)
    cam, *g = oracle_case(4, n, H, W, dev)
    bg = torch.full((3,), 0.5, device=dev)
    target = torch.as_tensor(np.random.default_rng(5).uniform(size=(H, W, 3)).astype(np.float32), device=dev)
    names = ("means", "scales", "quats", "opacity", "shs")
    values, grads = {}, {}
    for path, render in (("oracle", lambda s: render_reference(s, H, W, bg)),
                         ("tile", lambda s: rasterize(s, H, W, bg, config=cfg))):
        leaves = [x.clone().requires_grad_(True) for x in g]
        o = render(oracle_screen(cam, *leaves))
        loss = ((o["rgb"] - target) ** 2).mean() + 0.1 * o["depth"].mean() + 0.05 * o["acc"].mean()
        gs = torch.autograd.grad(loss, leaves)
        values[path], grads[path] = float(loss.detach()), dict(zip(names, gs))
    rel = abs(values["tile"] - values["oracle"]) / abs(values["oracle"])
    log(f"[oracle] gradient case: loss {values['tile']:.7f} against the oracle's {values['oracle']:.7f} "
        f"(rel {rel:.2e})")
    if rel > 1e-5:
        raise AssertionError(f"oracle gradient case: loss rel error {rel}")
    res["errors"]["gradients_scaled"] = compare_oracle_grads(grads["tile"], grads["oracle"], "gradient case")

    # the single-cloud renderer, both colour sources
    cam, means, scales, quats, opacity, shs = oracle_case(3, n, H, W, dev)
    colors = torch.as_tensor(np.random.default_rng(6).uniform(size=(n, 3)).astype(np.float32), device=dev)
    bg = torch.tensor([0.0, 1.0, 0.0], device=dev)
    for what, kw in (("shs", {"shs": shs, "sh_degree": 2}), ("colors_precomp", {"colors_precomp": colors})):
        before = _launch_counts()["tile_blend_instances"]
        with torch.no_grad():
            out = render_gaussians(cam, means, scales, quats, opacity, bg_color=bg, config=cfg, **kw)
            screen = oracle_screen(cam, means, scales, quats, opacity, kw.get("shs"),
                                   colors_precomp=kw.get("colors_precomp"))
            ref = render_reference(screen, H, W, bg)
        if _launch_counts()["tile_blend_instances"] != before + 1:
            raise AssertionError(f"render_gaussians ({what}) did not launch kernel 2.1 once")
        if not bool(out["visibility"].any()) or tuple(out["radii"].shape) != (n,):
            raise AssertionError(f"render_gaussians ({what}): radii {tuple(out['radii'].shape)}, none visible")
        res["errors"][f"render_gaussians_{what}"] = compare_oracle(out, ref, ORACLE_TOL, f"render_gaussians {what}")
    torch.cuda.synchronize()
    res["launches"] = _launch_counts()
    if any(v == 0 for v in res["launches"].values()):
        raise AssertionError(f"oracle checks: a main-path kernel was not launched: {res['launches']}")
    res["seconds"] = time.perf_counter() - t0
    log(f"[oracle] step 13a in {res['seconds']:.1f} s: launches {res['launches']}, errors {res['errors']}")
    return res


def demo_phase(dev, tmp: str, smi: str) -> dict:
    """13b-d: the demo scene (script.make_demo_scene, DEMO_FRAMES frames
    of camera 0 at its default 480x320, 20,000 LiDAR points) trained by
    `train --config configs/demo_synthetic.yaml` for its own DEMO_ITERS
    iterations in-process, then `render` and `metrics`; `make_ply` on
    its checkpoint; the repo's root script/summarize_train_log.py on its
    log, as a subprocess. Gates: every logged record finite; no instance
    dropped, or each growth by the watchdog's rule and none dropped after
    the last; the four main-path kernels launched in training; the
    log_images grids at 1,000 and 2,000; train_psnr at DEMO_ITERS at
    least DEMO_MIN_PSNR and DEMO_MIN_GAIN above its value at 500; the
    PLY's vertices the rows visible at viewer.frame_id. Returns the
    launches in training and in render_sets, and the numbers printed."""
    from street_gaussians_torch import make_ply as make_ply_cli
    from street_gaussians_torch import metrics as metrics_cli
    from street_gaussians_torch import render as render_cli
    from street_gaussians_torch import runner
    from street_gaussians_torch import train as train_cli
    from street_gaussians_torch.config import load_config
    from street_gaussians_torch.models.renderer import compose_frame
    from street_gaussians_torch.script.make_demo_scene import make_demo_scene
    from street_gaussians_torch.utils import ply
    from street_gaussians_torch.utils.image_io import imread

    here = os.path.dirname(os.path.abspath(__file__))
    recipe = os.path.join(here, "configs", "demo_synthetic.yaml")
    scene_dir, out = os.path.join(tmp, "demo_scene"), os.path.join(tmp, "demo_out")
    argv = ["--config", recipe, "--device", dev.type, "source_path", scene_dir, "model_path", out]
    res = {"card": smi}

    # ---- 13b. the scene, training, render, metrics ----
    t0 = time.perf_counter()
    np.random.seed(0)  # the actor's grid colours
    make_demo_scene(scene_dir, frames=DEMO_FRAMES, cameras=(0,), device=dev)
    torch.cuda.synchronize()
    res["scene_s"] = time.perf_counter() - t0
    _zero_counts()
    np.random.seed(0)
    t0 = time.perf_counter()
    final = train_cli.main(argv)
    torch.cuda.synchronize()
    res["train_wall_s"] = time.perf_counter() - t0
    res["train_launches"] = _launch_counts()
    if any(v == 0 for v in res["train_launches"].values()):
        raise AssertionError(f"demo: a main-path kernel was not launched in training: {res['train_launches']}")
    with open(os.path.join(out, "record", "train_log.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    bad = [r for r in recs if not all(math.isfinite(v) for v in r.values() if isinstance(v, (int, float)))]
    if bad or any(r.get("event") for r in recs):
        raise AssertionError(f"demo: non-finite or event records {bad[:3]} {[r for r in recs if r.get('event')]}")
    steps = [r for r in recs if "loss" in r]
    if [r["iteration"] for r in steps] != list(range(10, DEMO_ITERS + 1, 10)):
        raise AssertionError(f"demo: step records at {[r['iteration'] for r in steps][:5]}...")
    last = 0
    for ev in final["growth"]:
        if ev["to"] != 2 * ev["from"] and ev["to"] != 0:
            raise AssertionError(f"demo: growth {ev} not by the watchdog's rule")
        last = ev["iteration"]
    dropped = [r["iteration"] for r in steps if r["iteration"] > last and r["overflow"] != 0]
    if dropped:
        raise AssertionError(f"demo: instances dropped at iterations {dropped[:10]} (growth {final['growth']})")
    psnr = {r["iteration"]: r["train_psnr"] for r in recs if "train_psnr" in r}
    if sorted(psnr) != [500, 1000, DEMO_ITERS]:
        raise AssertionError(f"demo: evals at {sorted(psnr)}")
    for it in (1000, 2000):
        grid = imread(os.path.join(out, "log_images", f"{it}.png"))
        if grid.shape != (2 * 320, 3 * 480, 3):
            raise AssertionError(f"demo: log_images/{it}.png is {grid.shape}")
    res["psnr"] = [psnr[500], psnr[1000], psnr[DEMO_ITERS]]
    res["dens"] = [r for r in recs if "densify/points_total" in r][-1:]
    timing = final["timing"]
    steps_s = timing["total_s"] - timing["load_s"] - timing["eval_s"] - timing["save_s"] - timing["log_images_s"]
    res.update(it_per_s=DEMO_ITERS / steps_s, num_alive=final["num_alive"], growth=final["growth"],
               timing={k: v for k, v in timing.items() if k != "windows"},
               ms_per_step_median=float(np.median([w["ms_per_step"] for w in timing["windows"]])))
    t0 = time.perf_counter()
    _zero_counts()
    rendered = render_cli.main(argv)
    torch.cuda.synchronize()
    res["render_launches"] = _launch_counts()
    res["render_s"] = time.perf_counter() - t0
    res["render_ms"] = rendered.get("render_ms")
    t0 = time.perf_counter()
    scores = metrics_cli.main(argv)
    res["metrics_s"] = time.perf_counter() - t0
    res["metrics"] = {k: {m: v[m] for m in ("psnr", "ssim")} for k, v in scores.items()}
    if not all(math.isfinite(v) for r in res["metrics"].values() for v in r.values()):
        raise AssertionError(f"demo: metrics {res['metrics']}")
    log(f"[demo] train_psnr at 500 / 1000 / {DEMO_ITERS}: {res['psnr'][0]:.4f} / {res['psnr'][1]:.4f} / "
        f"{res['psnr'][2]:.4f} (the JAX package's records: exact-f32 CPU {JAX_DEMO_PSNR['jax_cpu_exact']}, TPU "
        f"{JAX_DEMO_PSNR['jax_tpu']}); {res['it_per_s']:.2f} it/s over the steps (median window "
        f"{res['ms_per_step_median']:.2f} ms/step), train wall {res['train_wall_s']:.1f} s, scene "
        f"{res['scene_s']:.1f} s, stages {json.dumps(res['timing'])}; {res['num_alive']} alive after densify "
        f"(last round {json.dumps(res['dens'])}); growth {res['growth']}; render {res['render_ms']} ms/view "
        f"({res['render_s']:.1f} s), metrics {json.dumps(res['metrics'])} ({res['metrics_s']:.1f} s); "
        f"launches in training {res['train_launches']}, in render_sets {res['render_launches']} ({smi})")
    if not (res["psnr"][2] >= DEMO_MIN_PSNR and res["psnr"][2] >= res["psnr"][0] + DEMO_MIN_GAIN):
        raise AssertionError(f"demo: train_psnr {res['psnr']} at 500 / 1000 / {DEMO_ITERS}: below "
                             f"{DEMO_MIN_PSNR} or less than {DEMO_MIN_GAIN} above 500's")

    # ---- 13c. make_ply on the demo checkpoint ----
    t0 = time.perf_counter()
    path = make_ply_cli.main(argv)
    vertex = ply.read_ply(path)["vertex"]
    cfg = load_config(recipe, argv[4:], "train")
    np.random.seed(0)
    scene = runner.build_trained_scene(cfg, dev)
    state = runner.load_trained_state(cfg, scene, dev)
    frame_id = cfg.viewer.get("frame_id", 0)
    view = next(v for v in sorted(scene.all_views, key=lambda v: v.frame_idx) if v.frame_idx == frame_id)
    with torch.no_grad():
        composed = compose_frame(state.params, state.aux, scene.table, scene.pose_data, view.frame_input,
                                 runner.EVAL_STEP, opts=runner.render_opts_from_cfg(cfg, "eval"))
    visible = composed["visible"]
    xyz = np.stack([vertex["x"], vertex["y"], vertex["z"]], axis=-1)
    if len(vertex) != int(visible.sum()) or not np.array_equal(xyz, composed["means3d"][visible].cpu().numpy()):
        raise AssertionError(f"make_ply: {len(vertex)} vertices for {int(visible.sum())} visible rows")
    res["ply_vertices"], res["make_ply_s"] = len(vertex), time.perf_counter() - t0
    log(f"[demo] make_ply: {len(vertex)} vertices = the rows visible at frame {frame_id}, read back "
        f"({res['make_ply_s']:.1f} s)")

    # ---- 13d. the root summarize_train_log.py on the port's log ----
    proc = subprocess.run([sys.executable, os.path.join(here, "script", "summarize_train_log.py"),
                           os.path.join(out, "record", "train_log.jsonl")], capture_output=True, text=True,
                          timeout=120)
    if proc.returncode != 0:
        raise AssertionError(f"summarize_train_log failed ({proc.returncode}):\n{proc.stderr[-2000:]}")
    for ln in proc.stdout.splitlines()[:4]:
        log(f"[demo] summarize_train_log: {ln}")
    return res


def step13_phase(dev, tmp: str, smi: str) -> dict:
    """Step 13 (see oracle_phase and demo_phase). Returns the kernels'
    launches (13a's checks, 13b's training and render_sets), the oracle's
    errors and the numbers printed."""
    t0 = time.perf_counter()
    a = oracle_phase(dev)
    torch.cuda.empty_cache()
    b = demo_phase(dev, tmp, smi)
    numbers = {"oracle": {k: v for k, v in a.items() if k != "launches"},
               "demo": {k: v for k, v in b.items() if not k.endswith("launches")},
               "seconds": time.perf_counter() - t0}
    log(f"[demo] step 13 in {numbers['seconds']:.1f} s ({smi})")
    return {"launches": {"oracle": a["launches"], "demo_train": b["train_launches"],
                         "demo_render": b["render_launches"]},
            "oracle_errors": a["errors"], "numbers": numbers}


if __name__ == "__main__":
    sys.exit(main())
