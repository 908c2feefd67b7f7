"""The trace arithmetic and the p95 rule on hand-made inputs."""

from __future__ import annotations

import json

import pytest

from benchmark.harness import stats
from benchmark.harness import trace as tr


def _trace():
    # host: range "screen_space" 0-100 us, "backward" 200-400; kernels
    # launched at 10 (in screen_space), 250 and 260 (in backward, from
    # another thread), a copy, one stream sync in backward
    ev = [
        {"cat": "user_annotation", "name": "screen_space", "ts": 0, "dur": 100},
        {"cat": "user_annotation", "name": "backward", "ts": 200, "dur": 200},
        {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 10, "dur": 2, "args": {"correlation": 1}},
        {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 250, "dur": 2, "args": {"correlation": 2}},
        {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 260, "dur": 2, "args": {"correlation": 3}},
        {"cat": "cuda_runtime", "name": "cudaStreamSynchronize", "ts": 300, "dur": 5},
        {"cat": "kernel", "name": "void blend_items_kernel<4>(...)", "ts": 20, "dur": 30, "args": {"correlation": 1}},
        {"cat": "kernel", "name": "tile_blend_bwd_kernel", "ts": 255, "dur": 40, "args": {"correlation": 2}},
        {"cat": "kernel", "name": "segsum_tiles_kernel", "ts": 280, "dur": 30, "args": {"correlation": 3}},
        {"cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 40, "dur": 20},
    ]
    return ev


def test_busy_is_the_union_of_device_intervals():
    dev = tr.device_events(_trace())
    # [20, 60] (kernel 20-50 and copy 40-60 overlap), [255, 310]
    assert tr.busy_ms(dev) == pytest.approx((40 + 55) / 1e3)
    s = tr.summarize_events(_trace(), 0, 400)
    assert s["window_ms"] == pytest.approx(0.4) and s["syncs"] == 1 and s["kernels"] == 3


def test_range_kernels_count_launches_from_any_thread():
    ev = _trace()
    r = tr.range_kernels(ev, "backward")
    assert r["ms"] == pytest.approx(0.07) and r["kernels"] == 2 and r["syncs"] == 1
    assert tr.range_kernels(ev, "backward", ("segsum",))["ms"] == pytest.approx(0.03)
    assert tr.range_kernels(ev, "screen_space")["kernels"] == 1
    assert tr.range_kernels(ev, "sky")["ranges"] == 0
    assert tr.named_kernels(ev, ("tile_blend_bwd",))["ms"] == pytest.approx(0.04)


def test_breakdown_top_ops_and_idle_gaps():
    ev = _trace()
    dev = tr.device_events(ev)
    top = tr.top_ops(dev)
    assert top[0] == ["tile_blend_bwd_kernel", pytest.approx(40e-6)]
    gaps = tr.idle_gaps(ev, dev, 0, 400)
    # the gaps: 0-20 (screen_space), 60-255 (host: 100-200 is outside
    # every range; at 60 screen_space is open), 310-400 (backward)
    assert gaps[0] == ["screen_space", pytest.approx(195e-6)]
    assert sorted(g[1] for g in gaps) == pytest.approx(sorted([20e-6, 195e-6, 90e-6]))


def test_trace_file_round_trip(tmp_path):
    p = tmp_path / "t.json"
    p.write_text(json.dumps({"traceEvents": _trace()}))
    assert len(tr.load_events(str(p))) == len(_trace())


@pytest.mark.parametrize("n,expect", [(1, 1), (20, 19), (100, 95), (101, 96), (400, 380)])
def test_p95_is_the_nearest_rank(n, expect):
    assert stats.percentile(list(range(1, n + 1)), 95) == expect
    assert stats.percentile(list(range(n, 0, -1)), 95) == expect


def test_spread_is_the_quartile_distance_over_the_median():
    assert stats.spread([1.0, 2.0, 3.0, 4.0, 5.0, 6.0]) == pytest.approx((5.25 - 1.75) / 3.5)
