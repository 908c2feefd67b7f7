"""Rank 0's kernel ms a batched train step launched while the program's
span grad_allreduce was open: the camera group's reduction of the
densification statistics, the gradients and the scalars
(train_lib.apply_gradients over parallel.comm)."""

from benchmark.harness import readers


def read(ctx):
    return readers.range_ms(ctx, "grad_allreduce")
