"""The frozen count functions against hand counts and against the
program's documented bench-frame figures (PERF.md's kernel table)."""

from __future__ import annotations

import pytest

from benchmark.harness import counts as C


def test_payload_rows():
    assert [C.payload_rows(F) for F in (1, 4, 8, 27)] == [16, 16, 16, 40]


def test_blend_forward_hand_count():
    # 3 pairs evaluated, 2 of them blended, F = 4: 17*3 + 17*2
    w = C.blend_fwd_work(3, 2, live=5, tiles=1, F=4)
    assert w["ops"] == 85
    assert w["bytes"] == 4 * (5 * 10 + 256 * 5 + 2)


def test_blend_backward_hand_count():
    w = C.blend_bwd_work(3, 2, live=5, tiles=1, F=4)
    assert w["ops"] == 17 * 3 + 71 * 2
    assert w["bytes"] == 4 * (5 * 10 + 2 * 256 * 5 + 5 * 16)


@pytest.mark.parametrize("F,evaluated,blended,bound_ms,kernel", [
    # the semantic bench frame at F = 27: 341,859,263 pairs evaluated,
    # 82,977,796 blended; bounds 0.1648 (2.1) and 0.3456 ms (2.2)
    (27, 341_859_263, 82_977_796, 0.1648, "fwd"),
    (27, 341_859_263, 82_977_796, 0.3456, "bwd"),
])
def test_bounds_match_the_documented_bench_frame(F, evaluated, blended, bound_ms, kernel):
    fn = C.blend_fwd_work if kernel == "fwd" else C.blend_bwd_work
    w = fn(evaluated, blended, live=0, tiles=0, F=F)
    assert w["ops"] / C.F32_PEAK * 1e3 == pytest.approx(bound_ms, abs=5e-5)


def test_bench_frame_totals():
    # kernel 2.1 at F = 4: 7,222,230,003 operations, 0.1078 ms
    assert 7_222_230_003 / C.F32_PEAK * 1e3 == pytest.approx(0.1078, abs=5e-5)
    # kernel 2.4: 539,789,312 bytes a step, 0.1611 ms
    assert 539_789_312 / C.HBM_PEAK * 1e3 == pytest.approx(0.1611, abs=5e-5)


def test_segsum_counts():
    w = C.segsum_work(rows=10, channels=16, segments=7)
    assert w["bytes"] == 4 * (160 + 10 + 112) and w["ops"] == 160
    assert C.sky_segsum_work(6, 24)["bytes"] == 4 * (12 * 6 + 6 + 12 * 24)
    assert C.payload_segsum_work(10, 7)["bytes"] == w["bytes"]


def test_roofline_share_takes_the_larger_bound():
    one_ms_ops = {"ops": int(C.F32_PEAK / 1e3), "bytes": 0}
    assert C.roofline_share(one_ms_ops, 2e-3) == pytest.approx(50.0)
    one_ms_bytes = {"ops": 0, "bytes": int(C.HBM_PEAK / 1e3)}
    assert C.roofline_share(one_ms_bytes, 1e-3) == pytest.approx(100.0)


def test_step_and_view_ops():
    parts = {"rows": 10, "pixels": 4, "sky_pixels": 4, "adam_elements": 100, "evaluated": 3, "blended": 2}
    want = (10 * (C.COMPOSE_PRE_OPS + C.COMPOSE_PRE_BWD_OPS) + (17 * 3 + 17 * 2) + (17 * 3 + 71 * 2)
            + 4 * (C.LOSS_PIXEL_OPS + C.LOSS_PIXEL_BWD_OPS) + 4 * 2 * C.SKY_PIXEL_OPS + 100 * C.ADAM_ELEMENT_OPS)
    assert C.step_ops(parts) == want
    assert C.view_ops(parts) == 10 * C.COMPOSE_PRE_OPS + 17 * 3 + 17 * 2 + 4 * C.SKY_PIXEL_OPS
