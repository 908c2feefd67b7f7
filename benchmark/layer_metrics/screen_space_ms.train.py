"""Kernel ms a train step launched in the program's range screen_space
(models.renderer compose + ops.preprocess)."""

from benchmark.harness import readers


def read(ctx):
    return readers.range_ms(ctx, "screen_space")
