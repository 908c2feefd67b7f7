"""Kernel ms a train step launched in the range optimizer (statistics,
learning rates, optim.adam)."""

from benchmark.harness import readers


def read(ctx):
    return readers.range_ms(ctx, "optimizer")
