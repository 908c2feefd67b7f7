"""Kernel 2.4 (segsum.cu: segsum_tiles_kernel, segsum_fixup_kernel,
segment_ranges_kernel): least time for the step's row-sums (payload and
sky gradients, harness/counts.segsum_work) over its kernel time, in %."""

from benchmark.harness import readers


def read(ctx):
    return readers.segsum_roofline(ctx)
