"""Idle share of the card: 1 - its busy time a view (the union of its
intervals in the profiled stretch) over the unprofiled window's time a
view, in %."""

from benchmark.harness import readers


def read(ctx):
    return readers.idle_share(ctx)
