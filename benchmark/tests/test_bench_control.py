"""The control and the planted faults fail the check, the program
passes it: the reference computed in TF32 (its matrix products' inputs
rounded to a 10-bit mantissa) in the program's place, a state left
unchanged, the loss over half the image, the densify round's thresholds
doubled, an altered answer (in rgb, acc and depth, or in rgb alone); at
a size a test run holds. And, on a card, run.py's line."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest
import torch

from conftest import ROOT, toy_cell
from benchmark.harness import check

CPU = torch.device("cpu")


def judged(numbers: dict) -> bool:
    """The check's verdict on the numbers given, each against its limit."""
    limits = {k: v for part in check.LIMITS.values() for k, v in part.items() if k in numbers}
    return check.judge(numbers, limits)[0]


@pytest.mark.parametrize("config,traffic", [("waymo_train_002", "train_densify"),
                                            ("waymo_val_006", "train_densify"),
                                            ("waymo_train_002", "train_objgate")])
def test_train_control_and_faults_fail(config, traffic):
    from benchmark import calibrate

    r = calibrate.train_readings(toy_cell(config, traffic, width=256), 2**31 + 11, CPU)
    assert judged(r["program"]), r["program"]
    densify = traffic == "train_densify"
    assert ("densify_gap" in r["program"]) == densify
    for side in ("control", "fault_half_batch", "fault_unchanged") + (("fault_densify_threshold",) if densify else ()):
        assert not judged(r[side]), (side, r[side])


def test_serve_control_and_fault_fail():
    from benchmark import calibrate

    r = calibrate.serve_readings(toy_cell("waymo_train_002", "serve_trajectory", width=320), 2**31 + 12, CPU, 3.0)
    assert judged(r["program"]), r["program"]
    for side in ("control", "fault_tile", "fault_tile_rgb"):
        assert not judged(r[side]), (side, r[side])


def test_tf32_rounding():
    from benchmark.reference.render import tf32

    x = torch.tensor([1.0, 1.0 + 2**-11, 1.0 + 2**-12, 3.14159265, -2.5e-3])
    assert tf32(x).tolist() == [1.0, 1.0 + 2**-10, 1.0, 3.140625, -0.0025005340576171875]


@pytest.mark.cuda
def test_run_py_prints_its_line_on_the_card(cuda_device):
    r = subprocess.run([sys.executable, os.path.join(ROOT, "benchmark", "run.py"), "--workload",
                        "waymo_train_002.serve_trajectory", "--seed", str(2**31 + 13), "--seconds", "3",
                        "--trace", "0"], capture_output=True, text=True, timeout=900, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-3000:]
    line = json.loads(r.stdout.strip().splitlines()[-1])
    assert set(line["metrics"]) == {"serve_views_per_s", "serve_view_ms_p95", "peak_mem_gib", "setup_s"}
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
    assert list(line)[-1] == "check"
