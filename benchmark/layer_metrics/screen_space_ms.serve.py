"""Kernel ms a served view launched in the range screen_space."""

from benchmark.harness import readers


def read(ctx):
    return readers.range_ms(ctx, "screen_space")
