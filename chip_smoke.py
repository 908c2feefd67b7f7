#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card (H100).

    python3 chip_smoke.py

1. prints the card's name and power limit (nvidia-smi);
2. builds both hand-written CUDA kernels from street_gaussians_torch/csrc;
3. holds each kernel against its plain PyTorch version on the card, on a
   random ragged case and on the bench frame's own inputs;
4. serves the bench scene (1600x1064, 220k background points grown x3 =
   661,248 rows, 4 actors, 1024 sky cubemap) through serve.render_views:
   one warm-up view, then 8 timed views, which must be finite, drop no
   instance and go through both kernels (launch counters);
5. times each kernel, its plain version and a one-call PyTorch
   yardstick, computes its bound, and prints one `kernels` JSON line;
6. prints {"ok": true, "device": {...}} as the last line.

Any failure raises (exit code != 0). Without CUDA, or without the rest
of the repository beside it, it fails before printing a result.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

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


def log(*args):
    print(*args, flush=True)


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean device time of fn() over reps calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


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


def random_blend_case(seed: int, dev, grid_x=40, grid_y=30, F=4, max_count=700, opacity_hi=0.99):
    """Ragged runs of random screen-space Gaussians (about a fifth of the
    tiles empty, the first run not block-aligned, features: rgb in
    [0, 1) then depths in [1, 50)). Returns tile_blend_instances' args."""
    from street_gaussians_torch.ops.tile_raster2 import payload_rows

    rng = np.random.default_rng(seed)
    T = grid_x * grid_y
    counts = rng.integers(0, max_count, T).astype(np.int32)
    counts[rng.uniform(size=T) < 0.2] = 0
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
    rows[sl, 5] = rng.uniform(0.02, opacity_hi, n)
    rows[sl, 6:5 + F] = rng.uniform(0, 1, (n, F - 1))
    rows[sl, 5 + F] = rng.uniform(1, 50, n)
    payload = np.concatenate(
        [rows.reshape(nb, 128, -1).transpose(0, 2, 1), np.zeros((1, rows.shape[1], 128), np.float32)]
    )
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=dev)  # noqa: E731
    return t(payload), t(starts), t(counts), F, grid_x, T


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from street_gaussians_torch import serve
    from street_gaussians_torch.kernels import _build
    from street_gaussians_torch.models.renderer import screen_space
    from street_gaussians_torch.models.sky_cubemap import build_sky_table
    from street_gaussians_torch.ops import binning, fill, rasterize, tile_raster2

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
    built = _build.build(["fill", "tile_blend"])
    log(f"[build] {time.perf_counter() - t0:.2f} s wall for both kernels")
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

    # ---- 5. kernel times, plain times, yardstick, bounds ----
    with torch.no_grad():
        ends = torch.cat([ex.offs[1:], ex.total.reshape(1)])
        cnt = ends - ex.offs
        lib_out = lambda: torch.nn.functional.pad(  # noqa: E731
            torch.repeat_interleave(ex.vals, cnt, dim=1, output_size=total), (0, S - total))
        if not torch.equal(lib_out(), a_out):
            raise AssertionError("repeat_interleave yardstick != expand_runs")
        a_ms = cuda_ms(lambda: fill.expand_runs(ex.vals, ex.offs, ex.total, S), 50)
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

    def bound(nbytes, ops):
        tb, to = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
        return (tb, "bytes") if tb >= to else (to, "operations")

    kernels = []
    for name, src, rep, n, err, ms, plain, lib, (bms, by) in (
        ("expand_runs", "street_gaussians_torch/csrc/fill.cu",
         "street_gaussians_tpu/ops/fill.py:55", launches["expand_runs"], err_a,
         a_ms, a_plain, a_lib, bound(a_bytes, a_ops)),
        ("tile_blend_instances", "street_gaussians_torch/csrc/tile_blend.cu",
         "street_gaussians_tpu/ops/tile_raster2.py:318", launches["tile_blend_instances"], err_b,
         b_ms, b_plain, None, bound(b_bytes, b_ops)),
    ):
        kernels.append({"name": name, "route": "cuda", "source": src, "replaces": rep,
                        "launches": n, "max_abs_err": err, "ms": ms, "kernel_ms": ms,
                        "plain_ms": plain, "bound_ms": bms, "bound_by": by, "library_ms": lib})
        log(f"[kernel] {name}: {ms:.4f} ms (plain {plain:.4f} ms, library "
            f"{'n/a' if lib is None else f'{lib:.4f} ms'}), bound {bms:.4f} ms by {by}")
    log(f"[kernel] bench-frame counts: expand_runs bytes {a_bytes}, compares {a_ops}; "
        f"tile_blend bytes {b_bytes}, f32 ops {b_ops}")

    log(smi)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
