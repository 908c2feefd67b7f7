"""Kernel ms a train step launched in the range object_render (the actors
rendered alone in train_lib.loss_and_grads)."""

from benchmark.harness import readers


def read(ctx):
    return readers.range_ms(ctx, "object_render")
