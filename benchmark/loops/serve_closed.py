"""Serving in a closed loop, one client: the views of `views` (all,
train or test) frame-major, each requested when the last is on the host
as uint8; sample_views of them compared, profiled_views traced
(harness/loops.run_serve)."""

from benchmark.harness.loops import run_serve as run  # noqa: F401
