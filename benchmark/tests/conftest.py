"""Shared fixtures of the benchmark's tests: the repository root on the
path, the `cuda` marker, and toy cells (the configurations' files at a
size the CPU runs in seconds)."""

from __future__ import annotations

import copy
import json
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA card; skipped without one")


def toy_cell(config: str, traffic: str, width: int = 192, rows: int = 4000):
    """A cell of BENCHMARK.json's files with the scene cut to a toy:
    `width` px wide images (the source's aspect), `rows` background
    rows, 6 frames, a 16-texel sky, a train cycle of its cell's last 4
    iterations; the rest as the files have it."""
    from benchmark.harness import manifest

    with open(os.path.join(ROOT, "benchmark", "configs", f"{config}.json")) as f:
        cfg = json.load(f)
    s = cfg["scene"]
    w0, h0 = s["image_size_source"]
    s.update(image_size_source=[width, round(width * h0 / w0)], width_cap=width, fx_source=s["fx_source"] * width / w0,
             frames=[s["frames"][0], s["frames"][0] + 5], sky_resolution=16, gaussian_scale_m=0.3,
             actor_gaussian_scale_m=0.2,
             rows={"background_capacity": rows * 3 // 2, "background_alive": rows, "actor_capacity": 512,
                   "actor_alive": 300})
    cfg["recipe"]["render"]["instance_capacity"] = 1 << 18
    with open(os.path.join(ROOT, "benchmark", "traffic", f"{traffic}.json")) as f:
        tr = json.load(f)
    if "cycle" in tr:  # the last 4 iterations of the cell's cycle, so that it ends as the cell's does
        tr.update(start_iteration=tr["start_iteration"] + tr["cycle"] - 4, cycle=4)
    tr.update(profiled_steps=2, sample_views=3, profiled_views=2)
    return manifest.Cell(name=f"{config}.{traffic}", chips=1, config_name=config, traffic_name=traffic,
                         config=copy.deepcopy(cfg), traffic=tr, end_to_end=[], per_layer=[])


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the chip)")
    return torch.device("cuda", 0)
