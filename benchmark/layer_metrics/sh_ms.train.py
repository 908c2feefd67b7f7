"""Kernel ms a train step launched while the program's span sh was open:
the SH colour's basis and coefficient product inside screen_space
(ops.preprocess), forward."""

from benchmark.harness import readers


def read(ctx):
    return readers.range_ms(ctx, "sh")
