"""Learning-rate schedules.

Port of street_gaussians_tpu/optim/schedule.py: the exponential
log-lerp schedule with delayed warmup of the reference's
get_expon_lr_func. The step is a Python int (the port runs eagerly), so
the rate is a Python float.
"""

from __future__ import annotations

import math


def expon_lr(
    step: int,
    lr_init: float,
    lr_final: float,
    lr_delay_steps: int = 0,
    lr_delay_mult: float = 1.0,
    max_steps: int = 1000000,
    warmup_steps: int = 0,
) -> float:
    """Log-linear interpolation from lr_init to lr_final over max_steps;
    0 before `warmup_steps` and when both endpoints are 0."""
    if lr_init == 0.0 and lr_final == 0.0:
        return 0.0
    if step < warmup_steps:
        return 0.0
    if lr_delay_steps > 0:
        delay = lr_delay_mult + (1.0 - lr_delay_mult) * math.sin(
            0.5 * math.pi * min(max(step / lr_delay_steps, 0.0), 1.0)
        )
    else:
        delay = 1.0
    t = min(max(step / max_steps, 0.0), 1.0)
    return delay * math.exp(math.log(lr_init) * (1.0 - t) + math.log(lr_final) * t)
