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
10. prints one `kernels` JSON line with all eight kernels (with the
   loaded sequence's launches before and after the gate, and step 9's in
   training and in render_sets);
11. prints {"ok": true, "device": {...}} as the last line.

Any failure raises (exit code != 0). Without CUDA, or without the rest
of the repository beside it, it fails before printing a result.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import os
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


def long_blend_case(seed: int, dev, opacity):
    """random_blend_case with LONG_RUNS on a 4x4 grid."""
    return random_blend_case(seed, dev, grid_x=4, grid_y=4, counts=LONG_RUNS,
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
    from street_gaussians_torch.models import sky_cubemap
    from street_gaussians_torch.models.renderer import render_frame
    from street_gaussians_torch.ops import fill, rasterize, segsum, tile_raster2
    from street_gaussians_torch.script import block_times
    from street_gaussians_torch.train_lib import init_train_state
    from street_gaussians_torch.utils import losses as L
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
    # against their plain versions (as step 8e); every step fn the runner
    # builds (again after a growth) is wrapped
    recs = {}
    make_step = runner.make_train_step

    def recording_make_step(*a, **kw):
        step_fn = make_step(*a, **kw)

        def step(state, *args, **kwargs):
            if state.step != RUN_ITERS - 1:
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

    # ---- 9a. train ----
    for k in kernels:
        k.launches = 0
    sync()
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    runner.make_train_step = recording_make_step
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
            losses.append(float(sc["loss"]))
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


if __name__ == "__main__":
    sys.exit(main())
