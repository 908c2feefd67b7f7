"""The benchmark's camera-batch reference (benchmark/reference/batch.py:
a batch of B views is the mean of B single-view reference gradients in
one Adam step) against the port's `make_data_parallel_train_step` on 4
Gloo ranks on the CPU, one camera a rank, through the benchmark's
`train_camdp` loop (benchmark/harness/camdp.py) at a toy size of cell
1's recipe (sky, LiDAR depth, actors with flips): its checked batched
steps and the cycle's densify round.

Tolerances, and why: the batch reference holds the 4-rank step as
benchmark/reference/train.py holds the single step (measured on the
toy: the loss within 2.3e-7, the gradient and change norms within
2.9e-6, the statistics within 9.3e-6, the densify round exact to
4.3e-10), so a thousandth of each limit of `correct`
(benchmark/harness/check.LIMITS) at most. The control: the same steps
against the single-view reference on rank 0's views alone, which is not
the batch's step, misses by far more.
"""

import copy
import json
import os
import tempfile
import time

import pytest
import torch

from benchmark.harness import camdp, check, loops, manifest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 2**31 + 23


def toy_camdp_cell(width: int = 96, rows: int = 2000) -> manifest.Cell:
    """waymo_train_002.train_camdp4 with the street cut to a toy: `width`
    px images, `rows` background rows, 6 frames, a 16-texel sky, the
    cycle's last 4 iterations (it ends in a densify round)."""
    with open(os.path.join(REPO, "benchmark", "configs", "waymo_train_002.json")) as f:
        cfg = json.load(f)
    s = cfg["scene"]
    w0, h0 = s["image_size_source"]
    s.update(image_size_source=[width, round(width * h0 / w0)], width_cap=width, fx_source=s["fx_source"] * width / w0,
             frames=[s["frames"][0], s["frames"][0] + 5], sky_resolution=16, gaussian_scale_m=0.3,
             actor_gaussian_scale_m=0.2,
             rows={"background_capacity": rows * 3 // 2, "background_alive": rows, "actor_capacity": 512,
                   "actor_alive": 300})
    cfg["recipe"]["render"]["instance_capacity"] = 1 << 16
    with open(os.path.join(REPO, "benchmark", "traffic", "train_camdp4.json")) as f:
        tr = json.load(f)
    tr.update(start_iteration=tr["start_iteration"] + tr["cycle"] - 4, cycle=4, profiled_steps=1)
    return manifest.Cell(name="waymo_train_002.train_camdp4", chips=4, config_name="waymo_train_002",
                         traffic_name="train_camdp4", config=copy.deepcopy(cfg), traffic=tr, end_to_end=[],
                         per_layer=[])


@pytest.fixture
def one_thread_ranks(monkeypatch, tmp_path):
    """One intra-op thread in this process and in the spawned ranks; the
    group's file in the test's directory."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_batch_reference_matches_four_gloo_ranks(one_thread_ranks):
    cell = toy_camdp_cell()
    seen = {}
    real = camdp.reference_train

    def keep(scene, cfg, start_it, rec, truths, **kw):
        seen.update(scene=scene, cfg=cfg, start_it=start_it, rec=rec, truths=truths)
        return real(scene, cfg, start_it, rec, truths, **kw)

    camdp.reference_train = keep
    try:
        out = camdp.run(cell, SEED, 0.5, False, torch.device("cpu"), time.perf_counter())
    finally:
        camdp.reference_train = real
    n = out.numbers
    assert out.attempted >= 1 and out.failed == 0 and n["checked_failed"] == 0
    assert {"loss_gap", "grad_gap", "change_gap", "stats_gap", "densify_gap"} <= set(n)
    for k, v in n.items():
        if k != "checked_failed":
            lim = {**check.LIMITS["train"], **check.LIMITS["densify"]}[k]
            assert v <= 1e-3 * lim, (k, v)
    # the control: rank 0's views alone through the single-view reference
    rec0 = [(views[0], draws[0], loss) for views, draws, loss in seen["rec"]]
    single = loops.reference_train(seen["scene"], seen["cfg"], seen["start_it"], rec0, seen["truths"])
    ref = real(seen["scene"], seen["cfg"], seen["start_it"], seen["rec"], seen["truths"])
    miss = check.train_numbers(single.losses, ref.losses, single.g, ref.g, single.dp, ref.dp)
    assert miss["grad_gap"] > 10 * check.LIMITS["train"]["grad_gap"], miss
