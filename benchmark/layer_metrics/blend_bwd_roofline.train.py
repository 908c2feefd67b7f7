"""Kernel 2.2 (tile_blend_bwd.cu: tile_blend_bwd_kernel,
tile_blend_bwd_wide_kernel): least time for the step's counted pairs
(harness/counts.blend_bwd_work) over its kernel time, in %."""

from benchmark.harness import readers


def read(ctx):
    return readers.blend_bwd_roofline(ctx)
