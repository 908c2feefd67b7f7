"""Device idle ms a served view in the gaps of the union of its device
intervals that begin while a `sync/` span is open on the host: the idle
that the eval render's host syncs cost."""

from benchmark.harness import spans


def read(ctx):
    return spans.sync_idle_ms(ctx)
