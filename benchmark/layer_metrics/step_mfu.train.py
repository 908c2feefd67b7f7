"""The train step's float32 operations (harness/counts.step_ops on the
step's own inputs) over the unprofiled window's seconds a step times the
card's 67 TFLOP/s, in %."""

from benchmark.harness import readers


def read(ctx):
    return readers.mfu(ctx)
