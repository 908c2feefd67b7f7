"""Kernel ms a served view launched in the range binning."""

from benchmark.harness import readers


def read(ctx):
    return readers.range_ms(ctx, "binning")
