"""The readers of the program's backward and sync spans on hand-made
traces, loaded as run.py loads them (layer_metrics/<name>.py)."""

from __future__ import annotations

import pytest

from benchmark.harness import manifest
from benchmark.harness import trace as tr


def _launch(ts, corr):
    return {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": ts, "dur": 1, "args": {"correlation": corr}}


def _kernel(ts, dur, corr, name="k"):
    return {"cat": "kernel", "name": name, "ts": ts, "dur": dur, "args": {"correlation": corr}}


def _ctx(events, steps=1, lo=0, hi=1000):
    return {"trace": tr.summarize_events(events, lo, hi), "steps": steps}


def _backward_trace(with_spans=True):
    # host: backward 100-500 on the main thread; on autograd's thread
    # tile_blend_bwd 150-200, payload_bwd 250-300, sky_bwd 320-340,
    # rows_bwd 360-370. Kernels launched at 120 (autograd, 10 us), 160
    # (2.2, 40), 260 (payload, 30), 330 (sky, 5), 365 (rows, 3), 400
    # (autograd, 20), and 50 (before the backward, 7).
    ev = [{"cat": "user_annotation", "name": "backward", "ts": 100, "dur": 400, "tid": 1}]
    if with_spans:
        ev += [{"cat": "user_annotation", "name": n, "ts": a, "dur": d, "tid": 2}
               for n, a, d in (("tile_blend_bwd", 150, 50), ("payload_bwd", 250, 50), ("sky_bwd", 320, 20),
                               ("rows_bwd", 360, 10))]
    for i, (ts, dur) in enumerate(((120, 10), (160, 40), (260, 30), (330, 5), (365, 3), (400, 20), (50, 7))):
        ev += [_launch(ts, i), _kernel(ts + 500, dur, i)]
    return ev


def _sync_trace(with_spans=True):
    # device busy 0-100, 150-200, 400-450, 600-700; a sync/ span 90-160
    # on thread 2 (the gap 100-150 begins in it), losses 300-500 with no
    # sync span (the gap 200-400 begins outside every sync span), a
    # sync/ span 440-460 (the gap 450-600 begins in it)
    ev = [_kernel(0, 100, 1), {"cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 150, "dur": 50},
          _kernel(400, 50, 2), _kernel(600, 100, 3),
          {"cat": "user_annotation", "name": "losses", "ts": 300, "dur": 200, "tid": 1}]
    if with_spans:
        ev += [{"cat": "user_annotation", "name": "sync/clip_bounds", "ts": 90, "dur": 70, "tid": 2},
               {"cat": "user_annotation", "name": "sync/lr_scalars", "ts": 440, "dur": 20, "tid": 1}]
    return ev


def test_autograd_vjp_ms_is_backward_outside_the_four_spans():
    read = manifest.reader("autograd_vjp_ms.train")
    assert read(_ctx(_backward_trace(), steps=2)) == pytest.approx((10 + 20) / 1e3 / 2)
    assert read(_ctx(_backward_trace(with_spans=False))) is None


def test_payload_bwd_ms_reads_its_span():
    read = manifest.reader("payload_bwd_ms.train")
    assert read(_ctx(_backward_trace())) == pytest.approx(30 / 1e3)
    assert read(_ctx(_backward_trace(with_spans=False))) is None


@pytest.mark.parametrize("name", ["sync_idle_ms.train", "sync_idle_ms.serve"])
def test_sync_idle_counts_gaps_that_begin_in_a_sync_span(name):
    read = manifest.reader(name)
    assert read(_ctx(_sync_trace(), steps=2)) == pytest.approx((50 + 150) / 1e3 / 2)
    assert read(_ctx(_sync_trace(with_spans=False))) is None
