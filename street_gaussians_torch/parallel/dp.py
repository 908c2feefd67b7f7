"""Camera data parallel training over a torch.distributed process group.

Port of street_gaussians_tpu/parallel/dp.py. Where the JAX package maps
one camera to each device of a 'data' mesh axis, the port maps one
camera to each rank of a parallel.comm.Group. Every rank renders its
camera end to end (compose, preprocess, binning, the blend kernels,
sky, losses, backward); then train_lib.apply_gradients reduces over the
group: the densification statistics are per-camera norms summed over
the batch (`denom` summed, `max_radii` the max), the parameter
gradients and the scalars averaged, the overflow counters summed, and a
row is active where its model is in range in any camera. Every rank
then takes the same masked Adam update, so the parameters stay bit-equal
on every rank: a batch of B cameras is B reference iterations'
gradients averaged into one step.

With tile_shards D > 1 each rank renders its camera in D tile-row bands
in turn (parallel/tiles.py): the port's form of the JAX package's
('data', 'tile') mesh.

Multi-host (train.multihost, the JAX package's multi-host runtime):
each host trains on its own disjoint slice of every shuffled epoch
(`node_views`), and its ranks take their cameras of the batch from it.

The random draws: every rank draws the flips and sky jitters of all B
cameras from one generator seeded alike on every rank and takes its
own (train_lib.take_draws), so the generators stay in step for
densify, which every rank runs on the same state.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from street_gaussians_torch.models import gaussians as G
from street_gaussians_torch.models.actor_pose import ActorPoseData
from street_gaussians_torch.models.renderer import RenderOptions
from street_gaussians_torch.parallel.comm import Group
from street_gaussians_torch.parallel.tiles import make_tile_sharded_train_step
from street_gaussians_torch.train_lib import flatten_params, make_train_step, unflatten_params


def make_data_parallel_train_step(
    cfg,
    table: G.SceneTable,
    pose_data: Optional[ActorPoseData],
    opts: RenderOptions,
    group: Group,
    tile_shards: int = 1,
):
    """step_fn(state, frame, gt, generator=None, *, draws=None) -> (new
    state, scalars): this rank's camera (frame, gt) and draws, the
    group's reductions, the same update on every rank."""
    if tile_shards > 1:
        return make_tile_sharded_train_step(cfg, table, pose_data, opts, tile_shards, data_group=group)
    return make_train_step(cfg, table, pose_data, opts, data_group=group)


def pop_batch(view_stack: list, batch_size: int) -> list:
    """The next batch of views off the end of the shuffled stack: the
    last view and the batch-mates of its (H, W) popped after it (the
    others go back on the stack, in order), cycled when the stack is
    short (the JAX package's runner.py:787-813). Every rank pops the
    same batch from the same-seeded shuffle."""
    view = view_stack.pop()
    batch, rest = [view], []
    while view_stack and len(batch) < batch_size:
        v = view_stack.pop()
        if (v.H, v.W) == (view.H, view.W):
            batch.append(v)
        else:
            rest.append(v)
    view_stack.extend(rest)
    n_unique = len(batch)
    while len(batch) < batch_size:
        batch.append(batch[len(batch) % n_unique])
    return batch


def node_views(view_stack: list, node: int, nodes: int) -> list:
    """Host `node`'s disjoint slice view_stack[node::nodes] of a shuffled
    epoch, padded by wrapping to ceil(len / nodes) views, so that every
    host refills at the same iteration and the same-seeded shuffles stay
    in step (the JAX package's runner.py:770-784). A host's ranks then
    take their batch_size / nodes cameras from it with pop_batch."""
    per = -(-len(view_stack) // nodes)
    mine = view_stack[node::nodes]
    while len(mine) < per:
        mine.append(mine[len(mine) % max(len(mine), 1)])
    return mine


def broadcast_state(state, group: Group):
    """Rank 0's parameters and per-row state on every rank, for a state
    built, not restored: the scene build's threaded steps (the kNN
    scale init) need not give every process the same bits, and the
    ranks' parameters must start equal (the JAX package broadcasts its
    initial state across hosts the same way). Adam's moments start at
    zero on every rank."""
    flat = flatten_params(state.params)
    aux_fields = [f.name for f in dataclasses.fields(state.aux)]
    got = group.broadcast([*flat.values(), *(getattr(state.aux, f) for f in aux_fields)])
    params = unflatten_params(dict(zip(flat, got[:len(flat)])), state.params)
    aux = dataclasses.replace(state.aux, **dict(zip(aux_fields, got[len(flat):])))
    return dataclasses.replace(state, params=params, aux=aux)
