"""Kernel ms a train step launched, from any host thread, while the range
backward (autograd) was open."""

from benchmark.harness import readers


def read(ctx):
    return readers.range_ms(ctx, "backward")
