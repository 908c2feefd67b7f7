"""Tile-row bands: one camera's image rendered, and trained, in bands of
16-pixel tile rows.

Port of street_gaussians_tpu/parallel/tiles.py. The JAX package splits
a frame over the 'tile' axis of a device mesh, for scenes whose
per-frame instance lists exceed one chip's capacity and to shorten one
render over several chips. Here the bands are the unit of work:

  * with a band group (a parallel.comm.Group of D ranks), rank d renders
    band d and the band images are gathered in rank order;
  * with no group, the process renders bands 0..D-1 in turn and joins
    them (on one card, the bands run one after another).

Band d covers tile rows [d * gy_local, (d + 1) * gy_local) of the
frame's gy = ceil(H / 16), with gy_local = ceil(gy / D) (`band_layout`);
the last bands may lie partly or wholly past the image, whose padded
height H_pad = D * gy_local * 16 is cut back to H after the join.
Parameters and the per-Gaussian compose and preprocess are the same for
every band, so a process builds them once a frame (screen_space) and
each of its bands clips that screen to its rows
(ops/preprocess.clip_screen_to_rows), bins and blends only them at an
instance capacity of max(round_up(C // D, 128), 1024), and samples the
sky on its rows (at sky_downsample N it upsamples its own small sky
image, whose edge clamps at the band's edge, as the JAX bands do).

Training (`make_tile_sharded_train_step`): every band's render runs
forward and backward, and the losses read the joined full image (SSIM
windows cross band edges). The full image's sky jitter is drawn once,
padded to H_pad and sliced per band, so a band step takes the single
step's draws. In one process, autograd through the join already sums
each band's share of every gradient. Over a band group the step
differentiates loss / D: the gather's backward (a reduce-scatter) gives
each band its pixels' true cotangent, and one sum over the group turns
the band shares and the D copies of the paths that skip the gather
(the regularizers) into the whole gradient, as the JAX package's
calibration does (its tiles.py, the note above make_tile_sharded_train_step).
The radii are the max over the bands, the overflow counters their sum.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import torch

from street_gaussians_torch.models import gaussians as G
from street_gaussians_torch.models.actor_pose import ActorPoseData
from street_gaussians_torch.models.renderer import RenderOptions, render_frame, screen_space
from street_gaussians_torch.ops.preprocess import TILE
from street_gaussians_torch.parallel.comm import Group
from street_gaussians_torch.train_lib import layout_train_step
from street_gaussians_torch.utils.trace import span

IMAGE_KEYS = ("rgb", "acc", "depth", "T", "normals", "semantic")
COUNTERS = ("overflow", "overflow_instance", "overflow_tile", "num_instances")
EVAL_STEP = 10**9  # SH degree fully active


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


@dataclasses.dataclass(frozen=True)
class BandLayout:
    """D bands of gy_local tile rows over an H-row image (H_pad rows with
    the bands' padding)."""

    H: int
    D: int
    gy: int
    gy_local: int
    H_pad: int

    def band(self, d: int):
        """(tile_row_start, num_tile_rows) of band d."""
        return d * self.gy_local, self.gy_local


def band_layout(H: int, D: int) -> BandLayout:
    gy = (H + TILE - 1) // TILE
    gy_local = _round_up(gy, D) // D
    return BandLayout(H=H, D=D, gy=gy, gy_local=gy_local, H_pad=gy_local * TILE * D)


def band_capacity(instance_capacity: int, D: int) -> int:
    """A band's instance capacity: the frame's share, at least 1024."""
    return max(_round_up(instance_capacity // D, 128), 1024)


class Bands:
    """The bands this process renders and how their outputs join: with a
    group of D ranks its own band, else all D in turn."""

    def __init__(self, D: int, group: Optional[Group] = None):
        if D < 1:
            raise ValueError(f"tile bands: D = {D}")
        if group is not None and group.size != D:
            raise ValueError(f"a band group of {group.size} ranks cannot render {D} bands")
        self.D, self.group = D, group

    @property
    def mine(self) -> List[int]:
        return [self.group.rank] if self.group is not None else list(range(self.D))

    def rows(self, parts: List[torch.Tensor], H: int) -> torch.Tensor:
        """The full image's first H rows from this process's band images."""
        if self.group is not None:
            return self.group.gather_rows(parts[0])[:H]
        return torch.cat(parts, dim=0)[:H]

    def reduce(self, parts: List[torch.Tensor], op: str) -> torch.Tensor:
        """op ("sum" or "max") over all the bands of one per-band value."""
        local = torch.stack(parts)
        local = local.sum(dim=0) if op == "sum" else local.amax(dim=0)
        if self.group is not None:
            local = self.group.all_reduce([local], op)[0]
        return local


def join_bands(bands: Bands, outs: List[Dict[str, torch.Tensor]], H: int,
               keys=IMAGE_KEYS) -> Dict[str, torch.Tensor]:
    """The band outputs as one frame's: the images' first H rows, radii
    the max over the bands (clip_screen_to_rows zeroes a band's radius
    outside it), visibility radii > 0, the counters summed."""
    res = {k: bands.rows([o[k] for o in outs], H) for k in keys if k in outs[0]}
    res["radii"] = bands.reduce([o["radii"] for o in outs], "max")
    res["visibility"] = res["radii"] > 0
    for k in COUNTERS:
        res[k] = bands.reduce([o[k] for o in outs], "sum")
    return res


def band_opts(opts: RenderOptions, D: int) -> RenderOptions:
    """A layout's render options: at band_capacity when a frame renders
    in D > 1 bands."""
    return opts if D == 1 else dataclasses.replace(opts, instance_capacity=band_capacity(opts.instance_capacity, D))


def render_bands(params, aux, table: G.SceneTable, pose_data: Optional[ActorPoseData], frame, step: int,
                 opts: RenderOptions, screen_composed, bands: Bands, keys=IMAGE_KEYS,
                 sky_jitter: Optional[torch.Tensor] = None, **kw) -> Dict[str, torch.Tensor]:
    """The frame rendered from its shared screen_space, `screen_composed`:
    with one band the whole frame (render_frame), else the bands this
    process renders (render_frame(row_shard=)), joined (join_bands) with
    the images in keys. sky_jitter: the whole frame's [H, W, 2], sliced
    per band; kw: render_frame's other arguments."""
    if bands.D == 1:
        return render_frame(params, aux, table, pose_data, frame, step, opts=opts, sky_jitter=sky_jitter,
                            screen_composed=screen_composed, **kw)
    layout = band_layout(frame.cam.H, bands.D)
    if sky_jitter is not None:
        sky_jitter = torch.nn.functional.pad(sky_jitter, (0, 0, 0, 0, 0, layout.H_pad - frame.cam.H))
    outs = []
    for d in bands.mine:
        start, rows = layout.band(d)
        jit = None if sky_jitter is None else sky_jitter[start * TILE:(start + rows) * TILE]
        with span(f"band_{d}"):
            outs.append(render_frame(params, aux, table, pose_data, frame, step, opts=opts, sky_jitter=jit,
                                     row_shard=(start, rows), screen_composed=screen_composed, **kw))
    return join_bands(bands, outs, frame.cam.H, keys)


def _screen_space(params, aux, table, pose_data, frame, step, opts, **kw):
    with span("screen_space"):
        return screen_space(params, aux, table, pose_data, frame, step, opts, **kw)


def band_render(table: G.SceneTable, pose_data: Optional[ActorPoseData], opts: RenderOptions, bands: Bands,
                screen=_screen_space) -> Callable:
    """render(params, aux, frame, step, keys=IMAGE_KEYS, *, flip=None,
    mean2d_offset=None, include_mask=None, **kw) -> the frame's outputs:
    its screen built once by screen(params, aux, table, pose_data, frame,
    step, opts, flip=, mean2d_offset=, include_mask=) (default
    screen_space), then rendered by render_bands at band_opts (kw:
    render_frame's other arguments). The render of every layout of
    bands and row blocks, for eval and for train_lib.layout_train_step."""
    local_opts = band_opts(opts, bands.D)

    def render(params, aux, frame, step, keys=IMAGE_KEYS, flip=None, mean2d_offset=None, include_mask=None, **kw):
        sc = screen(params, aux, table, pose_data, frame, step, local_opts, flip=flip, mean2d_offset=mean2d_offset,
                    include_mask=include_mask)
        return render_bands(params, aux, table, pose_data, frame, step, local_opts, sc, bands, keys, **kw)

    return render


def make_row_sharded_render(
    table: G.SceneTable,
    pose_data: Optional[ActorPoseData],
    opts: RenderOptions,
    D: int,
    group: Optional[Group] = None,
    include_mask=None,
) -> Callable:
    """render(params, aux, frame, sky_table=None) -> at step 10^9, the
    whole frame's rgb/acc/depth/T (normals, semantic) [cam.H, ...],
    radii and visibility, the three overflow counters and num_instances
    summed over the bands. Rendered in D bands (see the module's
    docstring); differentiable in params (over a group, see
    make_tile_sharded_train_step for the gradient's calibration)."""
    bands = Bands(D, group)
    inner = band_render(table, pose_data, opts, bands)

    def render(params, aux, frame, sky_table=None):
        return inner(params, aux, frame, EVAL_STEP, include_mask=include_mask, sky_table=sky_table)

    render.bands = bands
    return render


def make_tile_sharded_train_step(
    cfg,
    table: G.SceneTable,
    pose_data: Optional[ActorPoseData],
    opts: RenderOptions,
    D: int,
    group: Optional[Group] = None,
    data_group: Optional[Group] = None,
):
    """The train step with every render in D tile-row bands:
    step_fn(state, frame, gt, generator=None, *, draws=None) -> (new
    state, scalars), train_lib.make_train_step's contract, with the
    single step's draws (the full image's jitter, sliced per band).
    group: a band group of D ranks (rank d renders band d), else the
    bands run in turn in this process. data_group: camera data parallel
    over a parallel.comm.Group, one camera a rank, each camera rendered
    in D bands in its process (the JAX package's ('data', 'tile') mesh);
    the reductions over cameras are train_lib.apply_gradients'. Each
    gradient loss_and_grads returns is the whole frame's."""
    render = band_render(table, pose_data, opts, Bands(D, group))
    if group is None:
        return layout_train_step(cfg, table, opts, render, data_group=data_group)

    def finish(g_params, g_m2d, g_abs, out):
        # band shares -> the whole gradient
        *g, g_m2d, g_abs = group.all_reduce([*g_params.values(), g_m2d, g_abs], "sum")
        return dict(zip(g_params, g)), g_m2d, g_abs, out

    return layout_train_step(cfg, table, opts, render, divisor=D, finish=finish, data_group=data_group)
