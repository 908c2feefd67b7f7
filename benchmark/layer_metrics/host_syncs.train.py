"""The host's stream and device synchronisations a train step (train_lib),
from the trace."""

from benchmark.harness import readers


def read(ctx):
    return readers.syncs_per_step(ctx)
