"""Training the static scene in cycles from a snapshot (harness/orbit.py):
iterations start_iteration + 1 to start_iteration + cycle, the snapshot
restored between cycles with the clock stopped; one training view a step
in seeded epochs; the checked first steps (checked_steps) against
reference/sh.py; profiled_steps traced."""

from benchmark.harness.orbit import run  # noqa: F401
