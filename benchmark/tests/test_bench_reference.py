"""The plain reference against the program at toy size on the CPU, the
harness driven to its end without a card, and the faults it must
catch."""

from __future__ import annotations

import time

import pytest
import torch

from conftest import toy_cell
from benchmark.harness import check, loops

CPU = torch.device("cpu")


@pytest.mark.parametrize("config,traffic", [
    ("waymo_train_002", "train_densify"),
    ("waymo_val_006", "train_densify"),
    ("waymo_train_002", "train_objgate"),
])
def test_train_cells_agree_with_the_reference(config, traffic):
    cell = toy_cell(config, traffic)
    out = loops.run_train(cell, 2**31 + 3, 1.0, False, CPU, time.perf_counter())
    ok, rows = check.judge(out.numbers, out.limits)
    assert ok, rows
    assert out.attempted >= 1 and out.failed == 0 and out.numbers["checked_failed"] == 0
    # far inside the limits at this size
    assert out.numbers["loss_gap"] < 1e-5 and out.numbers["grad_gap"] < 1e-3
    # the densify cells check the round at their cycle's end, the gate cell has none
    assert ("densify_gap" in out.limits) == (traffic == "train_densify")


def test_serve_cell_agrees_with_the_reference():
    cell = toy_cell("waymo_train_002", "serve_trajectory")
    out = loops.run_serve(cell, 2**31 + 4, 4.0, False, CPU, time.perf_counter())
    ok, rows = check.judge(out.numbers, out.limits)
    assert ok, rows
    assert out.numbers["views_compared"] >= 1 and out.failed == 0
    assert out.e2e["serve_views_per_s"] > 0 and out.e2e["serve_view_ms_p95"] > 0


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "densify_threshold"])
def test_train_faults_come_out_not_correct(fault):
    cell = toy_cell("waymo_train_002", "train_densify")
    out = loops.run_train(cell, 2**31 + 5, 0.5, False, CPU, time.perf_counter(), fault=fault)
    ok, rows = check.judge(out.numbers, out.limits)
    assert not ok, rows
    if fault == "densify_threshold":  # the steps are sound: only the round's numbers fail
        bad = {k for k, v, lim in rows if not v <= lim}
        assert bad == {"densify_gap"}, rows


@pytest.mark.parametrize("fault", ["tile", "tile_rgb"])
def test_serve_fault_comes_out_not_correct(fault):
    cell = toy_cell("waymo_train_002", "serve_trajectory")
    out = loops.run_serve(cell, 2**31 + 6, 4.0, False, CPU, time.perf_counter(), fault=fault)
    ok, rows = check.judge(out.numbers, out.limits)
    assert not ok, rows


def test_traced_run_counts_its_work_and_reads_its_metrics():
    from benchmark.harness import manifest

    cell = toy_cell("waymo_train_002", "train_densify")
    out = loops.run_train(cell, 2**31 + 7, 0.5, True, CPU, time.perf_counter())
    w = out.layer_ctx["work"]
    assert w["evaluated"] >= w["blended"] > 0 and w["rows"] > 0
    assert manifest.reader("step_mfu.train")(out.layer_ctx) > 0
    # no device on the CPU: the device's readers find nothing to read
    assert manifest.reader("blend_fwd_roofline.train")(out.layer_ctx) is None
    assert out.device["breakdown"]["device_ops"] == []


def test_reference_render_counts_against_a_loop():
    """The blend's pair counts and image on a few Gaussians against a
    per-pixel loop over the depth-sorted list."""
    from benchmark.reference import render as R

    g = torch.Generator().manual_seed(0)
    n, H, W = 40, 32, 48
    s = {"mean2d": torch.rand(n, 2, generator=g) * torch.tensor([W, H]),
         "conic": torch.stack([torch.full((n,), 0.05), torch.zeros(n), torch.full((n,), 0.05)], -1),
         "depth": torch.rand(n, generator=g) + 1, "opacity": torch.rand(n, generator=g) * 0.9 + 0.05,
         "valid": torch.ones(n, dtype=torch.bool), "grid": (3, 2)}
    s["rmin"] = torch.zeros(n, 2, dtype=torch.int64)
    s["rmax"] = torch.tensor([[3, 2]] * n)
    s["touched"] = torch.full((n,), 6)
    feats = torch.rand(n, 4, generator=g)
    img, cnt = R.rasterize(s, feats, torch.zeros(3), count=True)
    order = torch.argsort(s["depth"], stable=True)
    ev = bl = 0
    for y in range(H):
        for x in range(W):
            T, acc = 1.0, torch.zeros(4, dtype=torch.float64)
            tile = (y // 16) * 3 + x // 16
            for i in order.tolist():
                # the cut: pairs that cannot reach 1/255 in this tile are skipped
                if not _reaches(s, i, tile):
                    continue
                ev += 1
                dx, dy = float(s["mean2d"][i, 0]) - x, float(s["mean2d"][i, 1]) - y
                a, b, c = (float(v) for v in s["conic"][i])
                power = -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy
                alpha = min(0.99, float(s["opacity"][i]) * torch.exp(torch.tensor(min(power, 0.0))).item())
                if power > 0 or alpha < 1 / 255:
                    continue
                if T * (1 - alpha) < 1e-4:
                    break
                acc += alpha * T * feats[i].double()
                T *= 1 - alpha
                bl += 1
            assert torch.allclose(img[y, x, :4].double(), acc, atol=1e-5)
            assert abs(float(img[y, x, 4]) - T) < 1e-5
    assert cnt["blended"] == bl and cnt["evaluated"] == ev


def _reaches(s, i, tile):
    from benchmark.reference import render as R

    gid, tid, starts, _ = R.instances({**s, "touched": s["touched"]})
    return bool(((gid == i) & (tid == tile)).any())
