"""Camera data parallel training in cycles (harness/camdp.py): `ranks`
ranks, one camera each, a batch of `ranks` training views a step in
seeded epochs, the gradients reduced over the group; iterations
start_iteration + 1 to start_iteration + cycle from the snapshot,
restored between cycles with the clock stopped; the checked first
batched steps and the cycle's densify round against reference/batch.py;
profiled_steps traced on rank 0."""

from benchmark.harness.camdp import run  # noqa: F401
