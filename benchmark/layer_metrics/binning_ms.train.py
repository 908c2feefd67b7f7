"""Kernel ms a train step launched in the range binning (ops.binning,
kernel 2.3 in ops.fill)."""

from benchmark.harness import readers


def read(ctx):
    return readers.range_ms(ctx, "binning")
