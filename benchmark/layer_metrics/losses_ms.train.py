"""Kernel ms a train step launched in the range losses
(train_lib.compute_losses)."""

from benchmark.harness import readers


def read(ctx):
    return readers.range_ms(ctx, "losses")
