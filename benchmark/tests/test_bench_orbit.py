"""The static scene's cell (harness/orbit_scene.py, harness/orbit.py,
reference/sh.py) and the camera-DP loop's readers: the configuration's
published shapes, a scene reproducible from a seed, the check passing
the program and failing the control and the faults at a toy size, and
the per-layer readers that the new cells list reading their traces
(and reading nothing, without raising, where a program lacks a span)."""

from __future__ import annotations

import copy
import json
import os
import time

import pytest
import torch

from conftest import ROOT
from benchmark.harness import check, manifest, orbit, readers, spans
from benchmark.harness import orbit_scene as O

GARDEN = "mipnerf360_garden.train_refine"
CAMDP = "waymo_train_002.train_camdp4"


def _config():
    with open(os.path.join(ROOT, "benchmark", "configs", "mipnerf360_garden.json")) as f:
        return json.load(f)


def toy_garden(width: int = 64, rows: int = 2000) -> manifest.Cell:
    cfg = _config()
    cfg["scene"] = O.toy_config(cfg["scene"], width=width, rows=rows, views=9)
    cfg["recipe"]["render"].update(instance_capacity=1 << 15, max_instance_capacity=1 << 15)
    with open(os.path.join(ROOT, "benchmark", "traffic", "train_refine.json")) as f:
        tr = json.load(f)
    tr.update(start_iteration=tr["start_iteration"] + tr["cycle"] - 4, cycle=4, profiled_steps=2)
    return manifest.Cell(name=GARDEN, chips=1, config_name="mipnerf360_garden", traffic_name="train_refine",
                         config=copy.deepcopy(cfg), traffic=tr, end_to_end=[], per_layer=[])


def test_published_shapes():
    cfg = _config()
    s, r = cfg["scene"], cfg["recipe"]
    W, H, K, views, train = O.make_views(s)
    assert (W, H) == (1297, 840) and len(views) == 185 and len(train) == 161 and K[0, 0] == K[1, 1] == 1160.0
    assert s["sh_degree"] == r["model"]["gaussian"]["sh_degree"] == 3 and s["fourier_dim"] == 1
    assert r["data"]["type"] == "Colmap" and r["data"]["split_test"] == 8 and not r["data"]["white_background"]
    assert not r["model"]["nsg"]["include_sky"] and not r["model"]["nsg"]["include_obj"]
    assert s["rows"] == {"capacity": 6_291_456, "alive": 5_800_000}
    assert sum(s[k]["rows"] for k in O.GROUPS) == s["rows"]["alive"]
    assert r["render"]["instance_capacity"] == r["render"]["max_instance_capacity"] == 2**24
    o = r["optim"]
    for k, v in cfg["source_values"].items():
        if k in o:
            assert o[k] == v, k
    assert cfg["reduced"] == []


def test_same_seed_same_scene_and_every_ray_ends_on_a_surface():
    s = O.toy_config(_config()["scene"], width=64, rows=2000, views=5)
    a, b, c = (O.make_scene(s, seed, "cpu") for seed in (2**31 + 7, 2**31 + 7, 2**31 + 8))
    for f in ("xyz", "feat_dc", "feat_rest", "log_scale", "rot", "opacity_logit", "spheres"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert not torch.equal(a.xyz, c.xyz) and int(a.alive.sum()) == int(c.alive.sum()) == s["rows"]["alive"]
    t = O.make_truth(a, a.views[0], "cpu")
    assert torch.equal(t.image, O.make_truth(b, b.views[0], "cpu").image)
    assert t.image.min() >= 0.02 and t.image.max() <= 0.98 and t.image.std() > 0.05
    # the Gaussians lie on the surfaces the truth is cast against: each
    # one's colour is the texture's at its own position, within the noise
    alive = a.alive
    rgb = a.feat_dc[alive, 0] * O.SH_C0 + 0.5
    assert float(rgb.std()) > 0.05 and float(a.feat_rest[alive].std()) == pytest.approx(s["feat_rest_std"], rel=0.1)


def test_program_passes_the_control_and_faults_fail():
    cell = toy_garden()
    r = orbit.readings(cell, 2**31 + 11, torch.device("cpu"))
    limits = orbit.LIMITS
    assert check.judge(r["program"], limits)[0], r["program"]
    for side in ("control", "fault_half_batch", "fault_unchanged"):
        assert not check.judge(r[side], limits)[0], (side, r[side])


def test_the_loop_runs_and_counts_the_work():
    cell = toy_garden()
    out = orbit.run(cell, 2**31 + 12, 0.5, True, torch.device("cpu"), time.perf_counter())
    assert out.attempted >= 1 and out.failed == 0 and check.judge(out.numbers, out.limits)[0]
    w = out.layer_ctx["work"]
    assert w["evaluated"] >= w["blended"] > 0 and w["sky_pixels"] == 0 and w["texels"] == 0
    assert w["rows"] == cell.config["scene"]["rows"]["alive"]


def _ctx(ranges):
    """A hand-made trace: one kernel of 2 ms launched inside each range."""
    ev, t = [], 0
    for k, name in enumerate(ranges):
        ev += [{"cat": "user_annotation", "name": name, "ts": t, "dur": 100},
               {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": t + 10, "dur": 2, "args": {"correlation": k}},
               {"cat": "kernel", "name": f"k{k}", "ts": t + 20, "dur": 2000, "args": {"correlation": k}}]
        t += 5000
    from benchmark.harness import trace as tr

    return {"kind": "train", "steps": 1, "unprofiled_s": 0.1, "densify_s": 0.0, "work": {},
            "trace": tr.summarize_events(ev, 0, t)}


@pytest.mark.parametrize("metric,span", [("sh_ms.train", "sh"), ("allreduce_ms.train", "grad_allreduce")])
def test_new_readers_read_their_span_and_nothing_without_it(metric, span):
    read = manifest.reader(metric)
    assert read(_ctx(["screen_space", span])) == pytest.approx(2.0)
    assert read(_ctx(["screen_space", "backward"])) is None  # a program without the span


# the trace-only readers the camera cell would list (harness/camdp.py's
# ctx carries the trace and no counted work: a replay needs every rank)
CAMDP_METRICS = ("device_idle.train", "host_syncs.train", "sync_idle_ms.train", "screen_space_ms.train",
                 "binning_ms.train", "sky_ms.train", "losses_ms.train", "backward_ms.train", "autograd_vjp_ms.train",
                 "payload_bwd_ms.train", "optimizer_ms.train", "allreduce_ms.train")


def test_the_new_cells_list_only_readers_their_traces_feed():
    """Every per-layer metric the garden lists reads its trace; the
    garden counts its work with reference/sh.py, whose SH degree
    step_mfu's per-row operations (harness/counts.COMPOSE_PRE_OPS, degree
    1) do not count. The camera cell's readers read a trace with no
    counted work."""
    man = manifest.load_manifest()
    listed = {m["name"] for m in man["per_layer"] if GARDEN in m.get("workloads", [])}
    assert "sh_ms.train" in listed and "step_mfu.train" not in listed and "sky_ms.train" not in listed
    assert CAMDP not in {w["name"] for w in man["workloads"]}  # not a cell yet (PERF.md section 7)
    ctx = _ctx(["screen_space", "binning", "losses", "backward", "optimizer", "sky", "payload_bwd",
                "grad_allreduce", "sync/lr_scalars"])
    for m in CAMDP_METRICS:
        assert manifest.reader(m)(ctx) is not None, m
    assert spans.launched_ms(ctx, ("backward",), spans.BWD_SPANS) is not None
    assert readers.idle_share(ctx) is not None
