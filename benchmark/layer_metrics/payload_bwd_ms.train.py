"""Kernel ms a train step launched while the span payload_bwd was open:
the payload gather's gradient (the stable sort, the column gather and
the segmented row-sum, kernel 2.4)."""

from benchmark.harness import spans


def read(ctx):
    return spans.launched_ms(ctx, ("payload_bwd",))
