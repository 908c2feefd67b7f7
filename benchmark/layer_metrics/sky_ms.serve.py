"""Kernel ms a served view launched in the range sky."""

from benchmark.harness import readers


def read(ctx):
    return readers.range_ms(ctx, "sky")
