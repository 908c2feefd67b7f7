"""Training machinery: the single-camera train step, learning rates, the
loss stack, densify and opacity reset.

Port of street_gaussians_tpu/train_lib.py. One step renders the camera
in train mode (symmetry flip and sky jitter drawn from a
torch.Generator, or passed in as `draws`), computes the reference's
losses, takes the gradients of every parameter and of the two [C, 2]
view-space zeros that densification reads, accumulates the
densification statistics and applies the row-masked Adam update. The
parameters are updated as new tensors under torch.no_grad(); the
render's gradients come from the autograd Functions of the blend, the
payload gather, the sky lookup and rows_from_models, whose backward
passes are scatter-free and deterministic. With lambda_reg > 0 on a
scene with actors, a step at or after densify_until_iter renders the
actors alone a second time (the same flip, no sky) for the
object-opacity loss; before that step the JAX step weighs that loss by
0, and this one skips the render.

Semantics and normals (opts.use_semantic, opts.render_normal) are
rendered as extra blend channels; no loss reads them (as in the JAX
step), so their cotangents are zero and the semantic rows keep their
values.

The step is loss_and_grads (render, losses, autograd) followed by
apply_gradients (statistics, masks, learning rates, Adam), both built by
layout_train_step, which the camera data parallel step (parallel/dp.py),
the tile-band step (parallel/tiles.py) and the row-sharded step
(parallel/gauss.py) share: a layout gives it only its render, its
offset's rows, its loss divisor and its reductions of the gradients.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional

import torch

from street_gaussians_torch.config import Config
from street_gaussians_torch.models import gaussians as G
from street_gaussians_torch.models.actor_pose import ActorPoseData
from street_gaussians_torch.models.corrections import color_correction_reg, pose_correction_reg
from street_gaussians_torch.models.renderer import (
    FrameInput,
    RenderOptions,
    SceneParams,
    draw_flip,
    draw_sky_jitter,
    render_frame,
    render_object_mask,
)
from street_gaussians_torch.optim.adam import AdamState, adam_init, adam_update
from street_gaussians_torch.optim.densify import (
    DensifyConfig,
    DensifyNoise,
    add_stats,
    densify_and_prune,
    reset_opacity,
    step_stats,
)
from street_gaussians_torch.optim.schedule import expon_lr
from street_gaussians_torch.utils import losses as L
from street_gaussians_torch.utils.trace import span

GROUPS = ("gaussians", "actor_pose", "sky", "color_correction", "pose_correction")
GAUSS = "gaussians."


def flatten_params(params: SceneParams) -> Dict[str, torch.Tensor]:
    """{"group.field": tensor} over the groups that are present."""
    out = {}
    for group in GROUPS:
        obj = getattr(params, group)
        if obj is not None:
            for f in dataclasses.fields(obj):
                out[f"{group}.{f.name}"] = getattr(obj, f.name)
    return out


def unflatten_params(flat: Dict[str, torch.Tensor], like: SceneParams) -> SceneParams:
    """The SceneParams of `like`'s structure holding flat's tensors."""
    groups = {}
    for group in GROUPS:
        obj = getattr(like, group)
        groups[group] = None if obj is None else dataclasses.replace(
            obj, **{f.name: flat[f"{group}.{f.name}"] for f in dataclasses.fields(obj)}
        )
    return SceneParams(**groups)


@dataclasses.dataclass
class TrainState:
    params: SceneParams
    adam: AdamState  # keyed by flatten_params' names
    aux: G.GaussianAux
    step: int


@dataclasses.dataclass
class GroundTruth:
    """Per-camera supervision; absent guidance is a neutral tensor whose
    loss weight gates it off."""

    image: torch.Tensor  # [H, W, 3]
    mask: torch.Tensor  # [H, W, 1] bool
    sky_mask: torch.Tensor  # [H, W, 1] bool
    lidar_depth: torch.Tensor  # [H, W] (0 where invalid)
    obj_bound: torch.Tensor  # [H, W, 1] bool
    sky_scale: torch.Tensor  # scalar lambda_sky multiplier


class Draws(NamedTuple):
    """A step's random draws, passed in instead of drawn: the flip [C]
    bool and the sky jitter [H, W, 2] (None for a scene without sky)."""

    flip: torch.Tensor
    sky_jitter: Optional[torch.Tensor]


def init_train_state(params: SceneParams, aux: G.GaussianAux) -> TrainState:
    """Zero Adam state; the Gaussian leaves get per-row step counts."""
    flat = flatten_params(params)
    adam = adam_init(flat, row_counted={k for k in flat if k.startswith(GAUSS)})
    return TrainState(params=params, adam=adam, aux=aux, step=0)


def _gaussian_lr(cfg: Config, table: G.SceneTable, mid: torch.Tensor, step: int):
    """Per-row [C] learning rates of the Gaussian leaves (f32): xyz on
    the exponential schedule scaled by each model's spatial_lr_scale,
    actors with their *_obj overrides."""
    o = cfg.optim
    is_actor = mid > 0
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=mid.device)  # noqa: E731

    def actor_or(key_obj: str, default: float):
        return torch.where(is_actor, f32(o.get(key_obj, default)), f32(default))

    pos_init = actor_or("position_lr_init_obj", o.position_lr_init)
    pos_final = actor_or("position_lr_final_obj", o.position_lr_final)
    sls = table.spatial_lr_scale[mid]
    t = torch.clamp(f32(step) / o.position_lr_max_steps, 0.0, 1.0)
    xyz_lr = torch.exp(torch.log(pos_init * sls) * (1.0 - t) + torch.log(pos_final * sls) * t)
    feature_lr = actor_or("feature_lr_obj", o.feature_lr)
    feature_rest_lr = torch.where(
        is_actor,
        f32(o.get("feature_rest_lr_obj", o.get("feature_lr_obj", o.feature_lr) / 20.0)),
        f32(o.feature_lr / 20.0),
    )
    return {
        "xyz": xyz_lr,
        "feat_dc": feature_lr,
        "feat_rest": feature_rest_lr,
        "log_scale": actor_or("scaling_lr_obj", o.scaling_lr),
        "rot": actor_or("rotation_lr_obj", o.rotation_lr),
        "opacity_logit": actor_or("opacity_lr_obj", o.opacity_lr),
        "semantic": actor_or("semantic_lr_obj", o.get("semantic_lr", 0.01)),
    }


def make_lr_tree(cfg: Config, table: G.SceneTable, params: SceneParams, aux, step: int):
    """{name: learning rate} for every leaf of params: per-row tensors
    for the Gaussians, floats for the rest."""
    o = cfg.optim
    iters = cfg.train.iterations
    with span("sync/lr_scalars"):
        lr = {GAUSS + k: v for k, v in _gaussian_lr(cfg, table, aux.model_id, step).items()}
    if params.actor_pose is not None:
        # frozen until the first opacity reset
        for name, kind in (("opt_trans", "position"), ("opt_rots", "rotation")):
            lr[f"actor_pose.{name}"] = expon_lr(
                step, o[f"track_{kind}_lr_init"], o[f"track_{kind}_lr_final"],
                lr_delay_mult=o[f"track_{kind}_lr_delay_mult"],
                max_steps=o[f"track_{kind}_max_steps"],
                warmup_steps=o.opacity_reset_interval,
            )
    if params.sky is not None:
        lr["sky.cubemap"] = expon_lr(
            step, o.get("sky_cube_map_lr_init", 0.01), o.get("sky_cube_map_lr_final", 0.0001),
            max_steps=o.get("sky_cube_map_max_steps", iters),
        )
    if params.color_correction is not None:
        cc_lr = expon_lr(
            step, o.get("color_correction_lr_init", 5e-4), o.get("color_correction_lr_final", 5e-5),
            max_steps=o.get("color_correction_max_steps", iters),
        )
        lr["color_correction.affine"] = lr["color_correction.affine_sky"] = cc_lr
    if params.pose_correction is not None:
        pc_lr = expon_lr(
            step, o.get("pose_correction_lr_init", 5e-6), o.get("pose_correction_lr_final", 1e-6),
            max_steps=o.get("pose_correction_max_steps", iters),
        )
        lr["pose_correction.trans"] = lr["pose_correction.rots"] = pc_lr
    return lr


def trimmed_l1_depth(expected, lidar, mask_2d, trim: float = 0.95) -> torch.Tensor:
    """Masked L1 over the lowest 95% of per-pixel errors. The k-th
    smallest error comes from a 31-step bisection over the IEEE-754 bit
    patterns (non-negative floats order as their int bits), so it is
    exactly the sort's k-th value; it stays on the device (no host sync).
    NaN errors count as +inf."""
    err = L.jnp_abs(expected - lidar)
    masked = torch.where(mask_2d, err, torch.inf).detach()
    bits = masked.contiguous().view(torch.int32)
    n = mask_2d.sum()
    k = torch.clamp(torch.floor(trim * n.to(torch.float32)).to(torch.int32), min=1)
    lo = torch.zeros((), dtype=torch.int32, device=err.device)
    hi = torch.full((), 0x7F800000, dtype=torch.int32, device=err.device)
    for _ in range(31):
        mid = lo + torch.div(hi - lo, 2, rounding_mode="floor")
        enough = (bits <= mid).sum() >= k
        lo, hi = torch.where(enough, lo, mid + 1), torch.where(enough, mid, hi)
    thr = hi.view(torch.float32)
    keep = (err <= thr) & mask_2d & torch.isfinite(err)
    return torch.where(keep, err, 0.0).sum() / L.jnp_maximum(keep.sum().to(err.dtype), 1.0)


def compute_losses(
    out: Dict[str, torch.Tensor],
    gt: GroundTruth,
    params: SceneParams,
    cfg: Config,
    cam_image_id: int,
    aux: Optional[G.GaussianAux] = None,
    table: Optional[G.SceneTable] = None,
    out_obj: Optional[Dict[str, torch.Tensor]] = None,
):
    """The reference loss stack: L1 + DSSIM, sky BCE on the accumulated
    opacity, with `out_obj` (the actors rendered alone) the
    object-opacity loss against gt.obj_bound weighted by lambda_reg,
    trimmed LiDAR depth, the correction regularizers, and
    the dormant scale-flatten / box regularizers when their lambdas are
    set. Returns (loss, {name: scalar})."""
    o = cfg.optim
    scalars = {}
    image = out["rgb"]
    mask = gt.mask
    l1 = L.l1_loss(image, gt.image, mask)
    scalars["l1_loss"] = l1
    loss = (1.0 - o.lambda_dssim) * o.lambda_l1 * l1 + o.lambda_dssim * (
        1.0 - L.ssim(image, gt.image, mask=mask)
    )
    if o.lambda_sky > 0:
        acc = L.jnp_clip(out["acc"], 1e-6, 1.0 - 1e-6)[..., None]
        sky_loss = torch.where(gt.sky_mask, -torch.log(1.0 - acc), -torch.log(acc)).mean()
        sky_loss = sky_loss * gt.sky_scale
        scalars["sky_loss"] = sky_loss
        loss = loss + o.lambda_sky * sky_loss
    if out_obj is not None:
        # entropy inside the projected boxes, transparency outside
        acc_obj = L.jnp_clip(out_obj["acc"], 1e-6, 1.0 - 1e-6)[..., None]
        obj_acc_loss = torch.where(
            gt.obj_bound,
            -(acc_obj * torch.log(acc_obj) + (1 - acc_obj) * torch.log(1 - acc_obj)),
            -torch.log(1.0 - acc_obj),
        ).mean()
        scalars["obj_acc_loss"] = obj_acc_loss
        loss = loss + o.lambda_reg * obj_acc_loss
    if o.lambda_depth_lidar > 0:
        depth_mask = (gt.lidar_depth > 0.0) & mask[..., 0]
        # the reference divides by acc + 1e-10; the clamp bounds the
        # gradient on pixels a Gaussian barely grazes
        expected = out["depth"] / L.jnp_maximum(out["acc"], 1e-2)
        lidar_loss = trimmed_l1_depth(expected, gt.lidar_depth, depth_mask)
        scalars["lidar_depth_loss"] = lidar_loss
        loss = loss + o.lambda_depth_lidar * lidar_loss
    if o.lambda_color_correction > 0 and params.color_correction is not None:
        cc = color_correction_reg(params.color_correction, cam_image_id)
        scalars["color_correction_reg_loss"] = cc
        loss = loss + o.lambda_color_correction * cc
    if o.lambda_pose_correction > 0 and params.pose_correction is not None:
        pc = pose_correction_reg(params.pose_correction)
        scalars["pose_correction_reg_loss"] = pc
        loss = loss + o.lambda_pose_correction * pc
    if o.get("lambda_scale_flatten", 0.0) > 0 and aux is not None:
        sf = G.scale_flatten_loss(params.gaussians, aux.alive)
        scalars["scale_flatten_loss"] = sf
        loss = loss + o.lambda_scale_flatten * sf
    if o.get("lambda_box_reg", 0.0) > 0 and aux is not None and table is not None:
        br = G.box_reg_loss(params.gaussians, aux, table)
        scalars["box_reg_loss"] = br
        loss = loss + o.lambda_box_reg * br
    scalars["loss"] = loss
    return loss, scalars


def count_instances(scalars: dict, capacity: int, *outs) -> None:
    """Adds to scalars num_instances, the binning's (Gaussian, tile)
    instances summed over the step's renders (outs; None for a render
    not made), and instance_fill, that over one render's instance
    capacity: binning scans the whole capacity a render, so 1 -
    instance_fill is the scan's slack (past densify_until_iter two
    renders share one capacity's worth, and it reads up to 2)."""
    n = sum(o["num_instances"] for o in outs if o is not None)
    scalars["num_instances"] = n.to(torch.float32)
    scalars["instance_fill"] = scalars["num_instances"] / capacity


def take_draws(table: G.SceneTable, state: TrainState, cam, generator: Optional[torch.Generator],
               opts: RenderOptions, cameras: int = 1, index: int = 0,
               model_id: Optional[torch.Tensor] = None) -> Draws:
    """A step's random draws from `generator`, flip first, then the sky
    jitter of a [cam.H, cam.W] image (a scene with a sky); none without
    a generator or outside train mode. With `cameras` > 1 (a camera
    batch, parallel/dp.py) the draws of all the batch's cameras are taken
    in turn, so that every rank's generator stays in step with the
    others', and those of camera `index` are returned. model_id: the
    [C] model ids of the whole table (default state.aux.model_id), for a
    state that holds a block of its rows (parallel/gauss.py): the flip is
    the whole table's."""
    if opts.mode != "train" or generator is None:
        return Draws(None, None)
    dev = state.aux.alive.device
    mid = state.aux.model_id if model_id is None else model_id
    mine = None
    for b in range(cameras):
        flip = draw_flip(table, mid, generator)
        jitter = draw_sky_jitter(cam.H, cam.W, generator, dev) if state.params.sky is not None else None
        if b == index:
            mine = Draws(flip, jitter)
    return mine


def apply_gradients(cfg: Config, table: G.SceneTable, state: TrainState, cam, scalars: dict, out: dict,
                    g_params: Dict[str, torch.Tensor], g_m2d: torch.Tensor, g_abs: torch.Tensor,
                    data_group=None, row_group=None):
    """The post-gradient half of every layout's train step
    (layout_train_step): the densification statistics (while step <
    densify_until_iter), the per-row masks, the learning rates, the pose
    correction's weight decay and the masked Adam update. `out` holds the render's radii and overflow counters.
    With data_group (a parallel.comm.Group of cameras, one a rank), the
    statistics are per-camera norms summed over the group (the radius
    the max), the gradients and scalars are averaged, the overflow
    counters summed and a row is active where its model is in range in
    any camera (the JAX package's parallel/dp.py); every rank then
    takes the same update. With row_group (the gauss group of a state
    that holds a block of the rows, parallel/gauss.py) num_alive is
    summed over the group. Returns (new state, {name: 0-dim tensor})."""
    o = cfg.optim
    step = state.step
    collect = 1.0 if step < o.densify_until_iter else 0.0
    add, denom_add, max_r = step_stats(
        out["radii"] * collect, g_m2d * collect, g_abs * collect, cam.W, cam.H
    )
    mid = state.aux.model_id
    in_range = (cam.frame >= table.start_frame[mid]) & (cam.frame <= table.end_frame[mid])
    ovf = [out["overflow"], out["overflow_instance"], out["overflow_tile"]]
    if data_group is not None:
        with span("grad_allreduce"):
            add, denom_add, *ovf = data_group.all_reduce([add, denom_add, *ovf], "sum")
            max_r, in_range = data_group.all_reduce([max_r, in_range.to(torch.float32)], "max")
            in_range = in_range > 0
            names = list(g_params)
            g_params = dict(zip(names, data_group.all_reduce([g_params[k] for k in names], "mean")))
            names = list(scalars)
            scalars = dict(zip(names, data_group.all_reduce([scalars[k] for k in names], "mean")))
    aux = add_stats(state.aux, add, denom_add, max_r)
    # per-row activity: rows of models not visible at this frame get no
    # gradient and no Adam step (torch's set_to_none)
    row_mask = aux.alive & in_range
    values = flatten_params(state.params)
    mask = {k: row_mask for k in values if k.startswith(GAUSS)}
    lr = make_lr_tree(cfg, table, state.params, aux, step)
    for k in ("pose_correction.trans", "pose_correction.rots"):
        if k in g_params:  # weight decay 0.01
            g_params[k] = g_params[k] + 0.01 * values[k]
    new_values, new_adam = adam_update(values, g_params, state.adam, lr, mask)

    scalars["overflow"], scalars["overflow_instance"], scalars["overflow_tile"] = ovf
    scalars["num_alive"] = aux.alive.sum()
    if row_group is not None:
        scalars["num_alive"] = row_group.all_reduce([scalars["num_alive"]], "sum")[0]
    scalars = {k: v.detach() for k, v in scalars.items()}
    new_state = TrainState(
        params=unflatten_params(new_values, state.params), adam=new_adam, aux=aux, step=step + 1
    )
    return new_state, scalars


FULL_KEYS = ("rgb", "acc", "depth", "T")  # what the losses read of the full render
OBJECT_KEYS = ("acc",)  # and of the object render


def layout_train_step(cfg: Config, table: G.SceneTable, opts: RenderOptions, render, rows: Optional[int] = None,
                      divisor: int = 1, finish=None, data_group=None, row_group=None,
                      model_id: Optional[torch.Tensor] = None):
    """The train step of a layout, make_train_step's contract, built from
    what the layout changes:
      render(params, aux, frame, step, keys, **kw) -> the frame's
        render_frame dict, kw being render_frame's flip, sky_jitter,
        mean2d_offset, absgrad_dummy, include_mask and compose_sky, and
        keys the images that a join of bands must keep;
      rows: the rows of the mean2d offset (default the table's C);
      divisor: the loss is divided by it before the backward (a group's
        size, for the gradient's calibration);
      finish(g_params, g_m2d, g_abs, out) -> the same four: the layout's
        reductions of the gradients and its cut of the output.
    data_group and row_group: see apply_gradients; model_id: see
    take_draws. step_fn.loss_and_grads(state, frame, gt, generator=None,
    draws=None) -> (scalars, render output, {name: gradient of each
    parameter}, gradient of the mean2d offset, of the AbsGS dummy); a
    parameter the loss does not reach gets 0."""
    o = cfg.optim
    C = table.capacity
    rows = C if rows is None else rows
    cameras, index = (1, 0) if data_group is None else (data_group.size, data_group.rank)
    obj_mask = None
    if o.lambda_reg > 0 and table.num_models > 1:
        # on the card once, so that the object render copies nothing
        obj_mask = torch.as_tensor(render_object_mask(table), device=table.start_frame.device)

    def loss_and_grads(state: TrainState, frame: FrameInput, gt: GroundTruth,
                       generator: Optional[torch.Generator] = None, draws: Optional[Draws] = None):
        # full float32 products, as the JAX code's precision="highest"
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        dev = state.aux.alive.device
        leaves = {k: p.detach().requires_grad_(True) for k, p in flatten_params(state.params).items()}
        params = unflatten_params(leaves, state.params)
        m2d_off = torch.zeros((rows, 2), device=dev, requires_grad=True)
        abs_dummy = torch.zeros((C, 2), device=dev, requires_grad=True)
        if draws is None:
            draws = take_draws(table, state, frame.cam, generator, opts, model_id=model_id)
        out = render(params, state.aux, frame, state.step, FULL_KEYS, flip=draws.flip,
                     sky_jitter=draws.sky_jitter, mean2d_offset=m2d_off, absgrad_dummy=abs_dummy)
        out_obj = None
        if obj_mask is not None and state.step >= o.densify_until_iter:
            # the actors alone: the same flip, no sky, and no view-space
            # offsets, so that densification sees only the full render
            with span("object_render"):
                out_obj = render(params, state.aux, frame, state.step, OBJECT_KEYS, flip=draws.flip,
                                 include_mask=obj_mask, compose_sky=False)
        with span("losses"):
            loss, scalars = compute_losses(
                out, gt, params, cfg, frame.cam.image_id, aux=state.aux, table=table, out_obj=out_obj
            )
        count_instances(scalars, opts.instance_capacity, out, out_obj)
        wrt = [*leaves.values(), m2d_off, abs_dummy]
        with span("backward"):
            grads = torch.autograd.grad(loss if divisor == 1 else loss / divisor, wrt, allow_unused=True)
        grads = [torch.zeros_like(x) if g is None else g for g, x in zip(grads, wrt)]
        g_params, g_m2d, g_abs = dict(zip(leaves, grads[:-2])), grads[-2], grads[-1]
        if finish is not None:
            g_params, g_m2d, g_abs, out = finish(g_params, g_m2d, g_abs, out)
        return scalars, out, g_params, g_m2d, g_abs

    def step_fn(state: TrainState, frame: FrameInput, gt: GroundTruth,
                generator: Optional[torch.Generator] = None, *, draws: Optional[Draws] = None):
        if draws is None:
            draws = take_draws(table, state, frame.cam, generator, opts, cameras, index, model_id)
        scalars, out, g_params, g_m2d, g_abs = loss_and_grads(state, frame, gt, draws=draws)
        with torch.no_grad(), span("optimizer"):
            scalars["psnr"] = L.psnr(out["rgb"], gt.image, gt.mask)
            return apply_gradients(cfg, table, state, frame.cam, scalars, out, g_params, g_m2d, g_abs,
                                   data_group, row_group)

    step_fn.loss_and_grads = loss_and_grads
    return step_fn


def make_train_step(
    cfg: Config,
    table: G.SceneTable,
    pose_data: Optional[ActorPoseData],
    opts: RenderOptions,
    data_group=None,
):
    """The single-camera train step:
    step_fn(state, frame, gt, generator=None, *, draws=None) ->
    (new state, {name: 0-dim tensor}). The random draws come from
    `generator` (flip first, then the sky jitter) unless `draws` gives
    them; with neither, the step draws none (no flip, no jitter).
    data_group: camera data parallel over a parallel.comm.Group (see
    apply_gradients and parallel/dp.py)."""

    def render(params, aux, frame, step, keys, **kw):
        return render_frame(params, aux, table, pose_data, frame, step, opts=opts, **kw)

    return layout_train_step(cfg, table, opts, render, data_group=data_group)


def _gaussian_adam(adam: AdamState) -> AdamState:
    pick = lambda t: {k[len(GAUSS):]: v for k, v in t.items() if k.startswith(GAUSS)}  # noqa: E731
    return AdamState(mu=pick(adam.mu), nu=pick(adam.nu), count=pick(adam.count))


def _merge_gaussian_adam(adam: AdamState, g: AdamState) -> AdamState:
    merge = lambda t, gt: {**t, **{GAUSS + k: v for k, v in gt.items()}}  # noqa: E731
    return AdamState(mu=merge(adam.mu, g.mu), nu=merge(adam.nu, g.nu), count=merge(adam.count, g.count))


def make_densify_fn(cfg: Config, table: G.SceneTable):
    """densify_fn(state, generator, prune_big_points, *, noise=None) ->
    (state, diagnostics): one densify-and-prune round over the Gaussian
    rows and their Adam state."""
    o = cfg.optim
    dcfg = DensifyConfig(
        densify_grad_threshold=o.densify_grad_threshold,
        densify_grad_threshold_bkgd=o.get("densify_grad_threshold_bkgd"),
        densify_grad_threshold_obj=o.get("densify_grad_threshold_obj"),
        densify_grad_abs_bkgd=o.densify_grad_abs_bkgd,
        densify_grad_abs_obj=o.densify_grad_abs_obj,
        percent_dense=o.percent_dense,
        percent_big_ws=o.percent_big_ws,
        min_opacity=o.min_opacity,
    )

    @torch.no_grad()
    def densify_fn(state: TrainState, generator: Optional[torch.Generator], prune_big_points,
                   *, noise: Optional[DensifyNoise] = None):
        new_g, new_gadam, new_aux, diag = densify_and_prune(
            state.params.gaussians, _gaussian_adam(state.adam), state.aux, table, dcfg,
            prune_big_points, generator=generator, noise=noise,
        )
        return dataclasses.replace(
            state,
            params=dataclasses.replace(state.params, gaussians=new_g),
            adam=_merge_gaussian_adam(state.adam, new_gadam),
            aux=new_aux,
        ), diag

    return densify_fn


def densify_cadence(cfg: Config, state: TrainState, iteration: int, densify_fn, reset_fn,
                    generator: Optional[torch.Generator]):
    """The reference's densify and reset cadence after the step numbered
    `iteration` (1-based; ref: train.py:186-210, runner.py:825-851):
    while iteration < densify_until_iter, densify every
    densification_interval iterations after densify_from_iter (pruning
    big points once iteration > opacity_reset_interval), reset the
    opacities every opacity_reset_interval iterations, and once more at
    densify_from_iter when data.white_background is set. Returns (state,
    densify's diagnostics, or None when it did not run)."""
    o = cfg.optim
    diag = None
    if iteration < o.densify_until_iter:
        if iteration > o.densify_from_iter and iteration % o.densification_interval == 0:
            with span("densify"):
                state, diag = densify_fn(state, generator, iteration > o.opacity_reset_interval)
        if iteration % o.opacity_reset_interval == 0:
            with span("densify"):
                state = reset_fn(state)
        if cfg.data.get("white_background", False) and iteration == o.densify_from_iter:
            with span("densify"):
                state = reset_fn(state)
    return state, diag


def make_reset_opacity_fn():
    """reset_fn(state) -> state with opacity clamped to <= 0.01 and its
    Adam moments zeroed (step counts kept)."""

    @torch.no_grad()
    def reset_fn(state: TrainState) -> TrainState:
        new_g, new_gadam = reset_opacity(state.params.gaussians, _gaussian_adam(state.adam))
        return dataclasses.replace(
            state,
            params=dataclasses.replace(state.params, gaussians=new_g),
            adam=_merge_gaussian_adam(state.adam, new_gadam),
        )

    return reset_fn
