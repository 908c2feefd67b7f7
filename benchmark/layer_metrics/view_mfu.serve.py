"""A served view's float32 operations (harness/counts.view_ops) over the
unprofiled window's seconds a view times 67 TFLOP/s, in %."""

from benchmark.harness import readers


def read(ctx):
    return readers.mfu(ctx)
