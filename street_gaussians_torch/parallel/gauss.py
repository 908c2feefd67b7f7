"""Gaussian-sharded rendering and training: the table's rows split into G
contiguous blocks.

Port of street_gaussians_tpu/parallel/gauss.py. The JAX package shards
every per-row leaf over the 'gauss' axis of a device mesh, for scenes
whose Gaussian rows and Adam moments do not fit one chip. Here a block
of rows is the unit of work:

  * with a gauss group (a parallel.comm.Group of G ranks), rank g holds
    the rows [g * C/G, (g + 1) * C/G) of every per-row leaf (the
    Gaussian parameters, their Adam mu / nu / count and the aux) and
    everything else replicated; it composes and preprocesses its rows
    alone, and one gather (Group.gather_rows_many) brings every rank the
    screen rows of the whole table, normals and semantics included;
  * with no group, one process holds all G blocks (the whole state) and
    composes and preprocesses them in turn; the join is torch.cat.

`Shards` says which blocks a process holds and how their screens join.
The joined rows are in table order, so binning, sorting and the blend
see exactly the whole table's screen: the integer outputs (binning
lists, tile_start / tile_count, the overflow counters, num_instances)
equal the single render's. With tile_shards T > 1 (the JAX package's
'gausstile' 2D mesh) every process renders the joined screen in T
tile-row bands in turn (parallel/tiles.py).

Training (`make_gauss_sharded_train_step`): every rank of a gauss group
computes the same full-image loss from the gathered screen rows. The
gradient's calibration (the JAX package's table, its gauss.py:152-170):

  | leaf                                  | how its gradient comes out     |
  | ------------------------------------- | ------------------------------ |
  | the step differentiates               | loss / G (loss with no group)  |
  | params.gaussians, the mean2d offset   | exact as they come: the        |
  | (this rank's rows)                    | gather's reduce-scatter sums   |
  |                                       | the G cotangents of loss / G   |
  | replicated leaves (sky, colour        | one sum over the gauss group   |
  | correction): true / G on every rank   |                                |
  | partial leaves (actor pose, pose      | one sum over the gauss group   |
  | correction): this rank's rows' share  |                                |
  | the [C, 2] AbsGS dummy (on the        | this rank's rows, times G      |
  | gathered side): true / G everywhere   |                                |
  | the radii (gathered)                  | this rank's rows               |

In JAX's 2D mesh the step differentiates loss / (G * T); here the T
bands run in turn in one process, and autograd through their join
already sums them. Then train_lib.apply_gradients runs on the local
rows: num_alive summed over the gauss group (row_group); with a data
group (gauss x camera: B cameras of G ranks, parallel.comm.Group.split)
its camera reductions run over the data sub-group, so every row block
is averaged over the cameras that share it.

The draws: the step draws the whole table's [C] flip (from the model
ids of the table, which every rank keeps) and takes its rows, so the
single step's draws and every rank's generator stay equal. (The JAX
package draws uniform(key, (local_rows,)) inside its shard_map, so its
sharded flips are not its single step's.)

Densify, the opacity reset and checkpoints need the whole table:
`gather_train_state` on every rank of the gauss group, the unchanged
function on the whole state (the same generator on every rank), then
`shard_train_state` again (Shards.gather / Shards.shard).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, List, Optional

import numpy as np
import torch

from street_gaussians_torch.models import gaussians as G_
from street_gaussians_torch.models.actor_pose import ActorPoseData
from street_gaussians_torch.models.renderer import RenderOptions, screen_space
from street_gaussians_torch.ops.preprocess import GaussianScreenData
from street_gaussians_torch.optim.adam import AdamState
from street_gaussians_torch.parallel.comm import Group
from street_gaussians_torch.parallel.tiles import EVAL_STEP, Bands, band_render
from street_gaussians_torch.train_lib import GAUSS, TrainState, layout_train_step
from street_gaussians_torch.utils.trace import span

EXTRAS = ("normals", "semantic")


def model_ids(table: G_.SceneTable) -> torch.Tensor:
    """The [C] model id of every table row (model m owns slices[m]), on
    the table's device: the whole table's, whichever rows a rank holds."""
    mid = np.zeros((table.capacity,), np.int64)
    for m, (s, e) in enumerate(table.slices):
        mid[int(s):int(e)] = m
    return torch.as_tensor(mid, device=table.start_frame.device)


class Shards:
    """The row blocks this process holds and how their screens join: with
    a gauss group of G ranks its own block (rank g: rows [g * C/G, (g + 1)
    * C/G)), else all G blocks, in turn."""

    def __init__(self, C: int, G: int, group: Optional[Group] = None):
        if G < 1 or C % G:
            raise RuntimeError(f"capacity {C} must divide the 'gauss' axis size {G} (pad the scene capacity)")
        if group is not None and group.size != G:
            raise ValueError(f"a gauss group of {group.size} ranks cannot hold {G} row blocks")
        self.C, self.G, self.group = C, G, group
        self.block_rows = C // G

    @property
    def offset(self) -> int:
        """The table row of this process's first row."""
        return 0 if self.group is None else self.group.rank * self.block_rows

    @property
    def local_rows(self) -> int:
        return self.C if self.group is None else self.block_rows

    @property
    def blocks(self) -> List[tuple]:
        """(first local row, first table row) of each block this process
        composes."""
        if self.group is not None:
            return [(0, self.offset)]
        return [(g * self.block_rows, g * self.block_rows) for g in range(self.G)]

    def local(self, x: torch.Tensor) -> torch.Tensor:
        """This process's rows of a whole-table [C, ...] tensor."""
        return x[self.offset:self.offset + self.local_rows]

    def join(self, parts: List[List[torch.Tensor]]) -> List[torch.Tensor]:
        """The whole table's rows of each leaf, from this process's blocks'
        (parts[block][leaf])."""
        if self.group is not None:
            return self.group.gather_rows_many(parts[0])
        return [torch.cat(leaf, dim=0) for leaf in zip(*parts)]

    def shard(self, state: TrainState) -> TrainState:
        """This process's rows of a whole state (in one process, the state)."""
        return state if self.group is None else shard_train_state(state, self.group.rank, self.G)

    def gather(self, state: TrainState) -> TrainState:
        """The whole state on every rank of the group (a collective)."""
        return state if self.group is None else gather_train_state(state, self)


def shard_rows(x: torch.Tensor, g: int, G: int) -> torch.Tensor:
    """Block g of G of x's rows, a copy (the whole can be freed)."""
    n = x.shape[0] // G
    return x[g * n:(g + 1) * n].clone()


def row_leaves(state: TrainState):
    """(the per-row leaves of a train state, rebuild(leaves) -> state):
    params.gaussians, their Adam mu / nu / count and the aux."""
    g = state.params.gaussians
    gf = [f.name for f in dataclasses.fields(g)]
    adam_keys = [GAUSS + f for f in gf]
    af = [f.name for f in dataclasses.fields(state.aux)]
    leaves = ([getattr(g, f) for f in gf] + [t[k] for t in state.adam for k in adam_keys]
              + [getattr(state.aux, f) for f in af])

    def rebuild(new: List[torch.Tensor]) -> TrainState:
        it = iter(new)
        gauss = dataclasses.replace(g, **{f: next(it) for f in gf})
        adam = AdamState(*({**t, **{k: next(it) for k in adam_keys}} for t in state.adam))
        aux = dataclasses.replace(state.aux, **{f: next(it) for f in af})
        return dataclasses.replace(state, params=dataclasses.replace(state.params, gaussians=gauss), adam=adam,
                                   aux=aux)

    return leaves, rebuild


def shard_train_state(state: TrainState, g: int, G: int) -> TrainState:
    """Rank g's state: block g of G of every per-row leaf (copies), the
    rest as it is."""
    leaves, rebuild = row_leaves(state)
    return rebuild([shard_rows(x, g, G) for x in leaves])


@torch.no_grad()
def gather_train_state(state: TrainState, shards: Shards) -> TrainState:
    """The inverse of shard_train_state over the gauss group: the whole
    table's rows of every per-row leaf on every rank (a collective: every
    rank of the group calls it)."""
    leaves, rebuild = row_leaves(state)
    return rebuild(shards.group.gather_rows_many(leaves)) if shards.group is not None else state


def _block(params, aux, lo: int, n: int):
    """The parameters and aux of local rows [lo, lo + n)."""
    cut = lambda obj: dataclasses.replace(  # noqa: E731
        obj, **{f.name: getattr(obj, f.name)[lo:lo + n] for f in dataclasses.fields(obj)})
    return dataclasses.replace(params, gaussians=cut(params.gaussians)), cut(aux)


def screen_rows(params, aux, table: G_.SceneTable, pose_data: Optional[ActorPoseData], frame, step: int,
                opts: RenderOptions, shards: Shards, flip: Optional[torch.Tensor] = None,
                mean2d_offset: Optional[torch.Tensor] = None, include_mask=None):
    """screen_space of the whole table, composed block by block on this
    process's rows (params, aux and mean2d_offset hold them) and joined:
    (screen, {"normals", "semantic"}) over all C rows, for
    render_frame(screen_composed=). flip: the whole table's [C] flip."""
    n = shards.block_rows
    parts = []
    for lo, row0 in shards.blocks:
        p, a = _block(params, aux, lo, n)
        with span("screen_space"):
            sc, comp = screen_space(
                p, a, table, pose_data, frame, step, opts,
                flip=None if flip is None else flip[row0:row0 + n],
                mean2d_offset=None if mean2d_offset is None else mean2d_offset[lo:lo + n],
                include_mask=include_mask, row_offset=row0,
            )
        parts.append([*sc, *(comp[k] for k in EXTRAS if comp[k] is not None)])
        has = [comp[k] is not None for k in EXTRAS]
    with span("gather_rows"):
        joined = shards.join(parts)
    nf = len(GaussianScreenData._fields)
    extra = iter(joined[nf:])
    return GaussianScreenData(*joined[:nf]), {k: next(extra) if h else None for k, h in zip(EXTRAS, has)}


def make_gauss_sharded_render(
    table: G_.SceneTable,
    pose_data: Optional[ActorPoseData],
    opts: RenderOptions,
    G: int,
    group: Optional[Group] = None,
    tile_shards: int = 1,
    include_mask=None,
) -> Callable:
    """render(params, aux, frame, sky_table=None) -> render_frame's dict
    at step 10^9 for the whole frame, params.gaussians and aux holding
    this process's rows (a group's rank: its block; else the whole
    table, composed in G blocks in turn). tile_shards T > 1: the joined
    screen rendered in T tile-row bands in turn, each at
    tiles.band_capacity (the JAX package's 'gausstile'), the overflow
    counters and num_instances summed over them. Differentiable in
    params (over a group, see make_gauss_sharded_train_step for the
    calibration)."""
    shards = Shards(table.capacity, G, group)
    inner = band_render(table, pose_data, opts, Bands(tile_shards), functools.partial(screen_rows, shards=shards))

    def render(params, aux, frame, sky_table=None):
        return inner(params, aux, frame, EVAL_STEP, include_mask=include_mask, sky_table=sky_table)

    render.shards = shards
    return render


def make_gauss_sharded_train_step(
    cfg,
    table: G_.SceneTable,
    pose_data: Optional[ActorPoseData],
    opts: RenderOptions,
    G: int,
    group: Optional[Group] = None,
    data_group: Optional[Group] = None,
    tile_shards: int = 1,
):
    """The train step on a row-sharded state: step_fn(state, frame, gt,
    generator=None, *, draws=None) -> (new state, scalars),
    train_lib.make_train_step's contract; state holds this process's
    rows (see the module's docstring), draws are the whole table's (the
    single step's). group: the gauss group of G ranks, else the G
    blocks in turn in this process. data_group: gauss x camera, one
    camera a gauss group (apply_gradients' camera reductions over it).
    tile_shards T > 1: every render in T tile-row bands in turn (gauss x
    tile; not with a data group, as in the JAX package).
    loss_and_grads returns this process's rows of the radii and of the
    mean2d offset's and AbsGS dummy's gradients, calibrated (the
    module's table)."""
    o = cfg.optim
    if o.get("lambda_scale_flatten", 0.0) > 0 or o.get("lambda_box_reg", 0.0) > 0:
        # these regularizers reduce over all rows; under sharding the
        # local sums would differ per rank (JAX's gauss.py:350-358)
        raise NotImplementedError(
            "lambda_scale_flatten / lambda_box_reg are not supported under gauss-sharded training yet")
    if tile_shards > 1 and data_group is not None:
        raise NotImplementedError("3D data x gauss x tile training is not wired (pick two axes)")
    shards = Shards(table.capacity, G, group)
    # the object render goes through the same gather (gauss.py:402-412)
    render = band_render(table, pose_data, opts, Bands(tile_shards), functools.partial(screen_rows, shards=shards))

    def finish(g_params, g_m2d, g_abs, out):
        if group is not None:
            # replicated and partial leaves: one sum over the gauss group
            rest = [k for k in g_params if not k.startswith(GAUSS)]
            g_params.update(zip(rest, group.all_reduce([g_params[k] for k in rest], "sum")))
            g_abs = shards.local(g_abs) * G
        return g_params, g_m2d, g_abs, dict(out, radii=shards.local(out["radii"]))

    step_fn = layout_train_step(cfg, table, opts, render, rows=shards.local_rows, divisor=1 if group is None else G,
                                finish=finish, data_group=data_group, row_group=group, model_id=model_ids(table))
    step_fn.shards = shards
    return step_fn


def whole_state(fn, shards: Shards, state: TrainState, *args, **kw):
    """fn(the whole state, *args, **kw) on a row-sharded state: gathered
    on every rank of the group, fn run on it (the same arguments, the
    same generator on every rank), sharded again. fn returns a state,
    or (state, extra)."""
    res = fn(shards.gather(state), *args, **kw)
    if isinstance(res, tuple):
        return (shards.shard(res[0]), *res[1:])
    return shards.shard(res)


def row_state_bytes(state: TrainState) -> int:
    """Bytes of the per-row leaves this process holds (parameters, Adam,
    aux)."""
    leaves, _ = row_leaves(state)
    return sum(x.numel() * x.element_size() for x in leaves)

