"""Plain PyTorch reference of a camera batch's training step: B cameras'
gradients averaged into one step (camera data parallel training).

A batch of B views is B reference iterations' gradients averaged into
one Adam step: each view's loss and gradients as reference/train.step
computes them (its own flip and sky jitter), their mean, the
densification statistics of every view summed (the largest radius
kept), and one masked Adam update of the rows alive whose model is in
the frame of any of the batch's views, at the batch's one learning rate
and step count. Nothing here imports or reads the program.
"""

from __future__ import annotations

from typing import List

import torch

from benchmark.reference import adam as ref_adam
from benchmark.reference import densify as ref_densify
from benchmark.reference import train as ref_train


def step(scene, state: dict, recipe: dict, views: List[object], truths: List[object], flips, jitters,
         object_loss: bool, statistics: bool = False):
    """One batched step; returns (new state, the mean loss, {leaf: the
    mean gradient}, the batch's summed statistics (reference/densify's
    accumulate over its views) or None)."""
    grads, losses, acc = None, [], None
    for view, truth, flip, jitter in zip(views, truths, flips, jitters):
        _, loss, g, st = ref_train.step(scene, state, recipe, view, truth, flip, jitter, object_loss,
                                        statistics=statistics)
        losses.append(loss)
        grads = g if grads is None else {k: grads[k] + g[k] for k in grads}
        if statistics:
            acc = ref_densify.accumulate(acc, st)
        del g, st
    B = len(views)
    grads = {k: v / B for k, v in grads.items()}
    m = scene.models
    in_any = torch.zeros(len(m.names), dtype=torch.bool, device=scene.model_id.device)
    for view in views:
        in_any |= torch.tensor([(m.start_frame[i] <= view.frame <= m.end_frame[i]) for i in range(len(m.names))],
                               device=in_any.device)
    rows = scene.alive & in_any[scene.model_id]
    new = ref_adam.step(state, grads, rows, ref_train.learning_rates(scene, recipe, state["step"]))
    return new, torch.stack(losses).mean(), grads, acc
