"""The port's tracing (street_gaussians_torch/utils/trace.py): spans that
cost a flag check without a profiler and open a range under one, the
spans a train step writes inside autograd's backward and around
densify, `train.trace_dir`'s trace of runner.training, the instance
counters in train_log.jsonl, and the sync arithmetic on hand-made
traces. CPU only, on the demo scene at 64x96."""

from __future__ import annotations

import json
import os
import re
import sys

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from street_gaussians_torch import runner as trunner
from street_gaussians_torch.config import load_config
from street_gaussians_torch.script.make_demo_scene import make_demo_scene
from street_gaussians_torch.utils import trace

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BWD_SPANS = ("tile_blend_bwd", "payload_bwd", "sky_bwd", "rows_bwd")
TRACED = (4, 6)  # train.trace_iterations; the densify round is at 5
ITERS = 10


def ranges(events, name=None):
    return [e for e in events if e.get("cat") == "user_annotation" and "dur" in e
            and (name is None or e["name"] == name)]


def inside(inner, outer):
    return outer["ts"] <= inner["ts"] and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]


@pytest.fixture(scope="module")
def traced_run(tmp_path_factory):
    """runner.training on the demo scene for ITERS iterations with a
    densify round at 5 and iterations TRACED traced (without
    tensorboard, whose import takes longer than the run)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    mp = pytest.MonkeyPatch()
    mp.setitem(sys.modules, "torch.utils.tensorboard", None)
    try:
        root = tmp_path_factory.mktemp("trace")
        scene_dir, out, trace_dir = str(root / "scene"), str(root / "out"), str(root / "trace")
        np.random.seed(0)
        make_demo_scene(scene_dir, frames=2, cameras=(0,), height=64, width=96, points=2000, seed=0, device="cpu")
        over = ["source_path", scene_dir, "model_path", out, "model.sky.resolution", "16",
                "optim.densify_from_iter", "1", "optim.densification_interval", "5",
                "train.iterations", str(ITERS), "train.test_iterations", "[]", "train.save_iterations", "[]",
                "train.checkpoint_iterations", "[]", "render.instance_capacity", "65536",
                "train.trace_dir", trace_dir, "train.trace_iterations", str(list(TRACED))]
        cfg = load_config(os.path.join(REPO, "configs", "demo_synthetic.yaml"), over, "train")
        np.random.seed(0)
        final = trunner.training(cfg, progress=False, device="cpu")
    finally:
        mp.undo()
        torch.set_num_threads(n)
    with open(os.path.join(out, "record", "train_log.jsonl")) as f:
        log = [json.loads(line) for line in f]
    return {"events": trace.load_events(os.path.join(trace_dir, "train_trace.json")), "log": log, "final": final,
            "capacity": cfg.render.instance_capacity}


def test_span_without_a_profiler_is_one_shared_null_context(monkeypatch):
    """No profiler: span returns the same null context every time and
    never calls into the profiler."""
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) without a profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    a, b = trace.span("backward"), trace.span("sync/lr_scalars")
    assert a is b
    with a:
        pass


def test_span_under_a_profiler_opens_a_range(tmp_path):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("outer"):
            with trace.span("sync/inner"):
                torch.ones(3).sum()
    path = str(tmp_path / "t.json")
    prof.export_chrome_trace(path)
    ev = trace.load_events(path)
    (outer,), (inner,) = ranges(ev, "outer"), ranges(ev, "sync/inner")
    assert inside(inner, outer)
    assert trace.host_spans(ev) == [inner]


def test_every_span_the_port_opens_is_listed():
    """SPANS names every literal span(...) of the package (band_{d} as
    band_<d>)."""
    pkg = os.path.join(REPO, "street_gaussians_torch")
    found = set()
    for dirpath, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py") and f != "trace.py":
                with open(os.path.join(dirpath, f)) as fh:
                    found |= set(re.findall(r'span\(f?"([^"]+)"\)', fh.read()))
    found = {re.sub(r"\{(\w+)\}", r"<\1>", n) for n in found}
    assert found == set(trace.SPANS)


def test_backward_spans_run_inside_backward_on_autograd_thread(traced_run):
    """The four backward spans lie inside a `backward` range in time, and
    each inside the autograd engine's evaluation of its Function on the
    same thread (autograd's thread)."""
    ev = traced_run["events"]
    backward = ranges(ev, "backward")
    assert len(backward) == TRACED[1] - TRACED[0] + 1
    engine = [e for e in ev if e.get("cat") == "cpu_op" and "dur" in e
              and e["name"].startswith("autograd::engine::evaluate_function")]
    for name in BWD_SPANS:
        spans = ranges(ev, name)
        assert len(spans) >= len(backward), name
        for s in spans:
            assert any(inside(s, b) for b in backward), name
            assert any(e["tid"] == s["tid"] and inside(s, e) for e in engine), name


def test_trace_dir_holds_the_iteration_densify_and_sync_spans(traced_run):
    """The traced iterations' view, ground_truth and the densify round
    at 5, with its own sync spans inside it; the step's sync spans; none
    of them past the traced iterations (the step scalars' read at 10)."""
    ev = traced_run["events"]
    names = {e["name"] for e in ranges(ev)}
    assert len(ranges(ev, "view")) == len(ranges(ev, "ground_truth")) == TRACED[1] - TRACED[0] + 1
    (dens,) = ranges(ev, "densify")
    for name in ("sync/densify_constants", "sync/densify_counts", "sync/densify_fill"):
        assert ranges(ev, name) and all(inside(s, dens) for s in ranges(ev, name)), name
    assert {"sync/lr_scalars", "sync/clip_bounds", "sync/stat_scale", "sync/compose_constants",
            "sync/sky_constants", "sync/camera_inverse", "optimizer", "losses", "sky"} <= names
    assert "sync/step_scalars" not in names
    for s in ranges(ev, "sync/lr_scalars"):
        assert any(inside(s, o) for o in ranges(ev, "optimizer"))


def test_train_log_carries_instance_counters(traced_run):
    rec = [r for r in traced_run["log"] if "loss" in r]
    assert [r["iteration"] for r in rec] == [ITERS]
    n, fill = rec[0]["num_instances"], rec[0]["instance_fill"]
    assert n > 0 and fill == pytest.approx(n / traced_run["capacity"], rel=1e-6) and fill < 1


def _sync_trace():
    # host: optimizer 0-300 with sync/lr_scalars 100-200 (thread 1); a
    # sync inside the span, one outside every span, one on another
    # thread during the span; device busy 0-110, 150-160, 250-300
    return [
        {"cat": "user_annotation", "name": "optimizer", "ts": 0, "dur": 300, "tid": 1},
        {"cat": "user_annotation", "name": "sync/lr_scalars", "ts": 100, "dur": 100, "tid": 1},
        {"cat": "cuda_runtime", "name": "cudaStreamSynchronize", "ts": 120, "dur": 20, "tid": 1},
        {"cat": "cuda_runtime", "name": "cudaDeviceSynchronize", "ts": 220, "dur": 20, "tid": 1},
        {"cat": "cuda_runtime", "name": "cudaStreamSynchronize", "ts": 150, "dur": 5, "tid": 2},
        {"cat": "kernel", "name": "k", "ts": 0, "dur": 110},
        {"cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 150, "dur": 10},
        {"cat": "kernel", "name": "k", "ts": 250, "dur": 50},
    ]


def test_sync_sites_tie_syncs_and_idle_to_their_spans():
    """The gap 110-150 begins inside sync/lr_scalars, the gap 160-250
    too (the span is open at 160); the sync at 220 is in no sync span,
    nor is the one on thread 2 (the span is thread 1's)."""
    got = trace.sync_sites(_sync_trace(), steps=2)
    assert got["sync/lr_scalars"] == pytest.approx({"syncs": 0.5, "idle_ms": (40 + 90) / 1e3 / 2})
    assert got["outside"] == pytest.approx({"syncs": 1.0, "idle_ms": 0.0})


def test_trace_stats_reports_sync_sites(tmp_path):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": _sync_trace()}))
    got = trace.trace_stats(str(path), 1)
    assert got["host_syncs"] == 3 and got["busy_ms"] == pytest.approx(0.17)
    assert got["sync_sites"]["sync/lr_scalars"]["syncs"] == 1
