"""Kernel ms a train step launched in the range sky (models.sky_cubemap)."""

from benchmark.harness import readers


def read(ctx):
    return readers.range_ms(ctx, "sky")
