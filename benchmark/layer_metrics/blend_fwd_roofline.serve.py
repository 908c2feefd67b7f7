"""Kernel 2.1 in the range tile_blend of a served view: least time for the
view's counted pairs over its kernel time, in %."""

from benchmark.harness import readers


def read(ctx):
    return readers.blend_fwd_roofline(ctx)
