"""Training in cycles from a snapshot: iterations start_iteration + 1 to
start_iteration + cycle, the snapshot restored between cycles with the
clock stopped; one training view a step in seeded epochs; the checked
first steps (checked_steps) and, where the cycle ends in a densify
round, that round; profiled_steps traced (harness/loops.run_train)."""

from benchmark.harness.loops import run_train as run  # noqa: F401
