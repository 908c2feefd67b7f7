"""Kernel 2.1 (ops.tile_raster2 forward, tile_blend.cu) in the range
tile_blend: its least time for the step's counted pairs
(harness/counts.blend_fwd_work) over its kernel time, in %."""

from benchmark.harness import readers


def read(ctx):
    return readers.blend_fwd_roofline(ctx)
