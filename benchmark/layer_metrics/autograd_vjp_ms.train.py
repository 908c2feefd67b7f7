"""Kernel ms a train step launched while the range backward was open but
none of the program's backward spans (tile_blend_bwd, payload_bwd,
sky_bwd, rows_bwd): autograd's own VJPs of compose, preprocess and the
losses."""

from benchmark.harness import spans


def read(ctx):
    return spans.launched_ms(ctx, ("backward",), spans.BWD_SPANS)
