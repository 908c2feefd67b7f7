"""Composite scene-graph renderer, forward.

Port of street_gaussians_tpu/models/renderer.py: one vectorized compose
over the packed Gaussian buffer (per-row gathers of per-model pose and
metadata), then preprocess -> binning -> tile blend, then sky cubemap
compositing and color correction. Per-frame visibility (actor lifetime)
goes through the `alive` mask; shapes never change.

Train mode takes the symmetry flip of the actors and the sky's
sub-pixel ray jitter as tensors (`flip`, `sky_jitter`), drawn by the
caller (draw_flip, draw_sky_jitter) or taken from the JAX package.
An include mask ([M] bool over the models) renders a subset of them:
the actors alone (render_object_mask) or the background alone
(render_background_mask).

Semantics (use_semantic: the background's first S = table.num_classes
columns, an actor's one channel in its class_label column) and normals
(render_normal: the rotation's min-scale axis, turned to face the
camera) are blended as extra features, normals first: F = 4 + 3 + S
blend channels (27 at 20 classes with normals). An eval render may
sample the sky on a 1/N ray grid (sky_downsample N): 2 is an exact
0.75/0.25 upsample, a larger N a bilinear one.

Not ported yet: tile-row sharding.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch.profiler import record_function

from street_gaussians_torch.models import gaussians as G
from street_gaussians_torch.models.actor_pose import (
    ActorInterp,
    ActorPoseData,
    ActorPoseParams,
    actor_poses,
)
from street_gaussians_torch.models.corrections import (
    ColorCorrectionParams,
    PoseCorrectionParams,
    apply_color_correction,
    correct_gaussian_rotation,
    correct_gaussian_xyz,
)
from street_gaussians_torch.models.sky_cubemap import SkyParams, render_sky
from street_gaussians_torch.ops.preprocess import preprocess_gaussians
from street_gaussians_torch.ops.rasterize import RasterizeConfig, rasterize
from street_gaussians_torch.utils import sh as sh_utils
from street_gaussians_torch.utils.camera import Camera
from street_gaussians_torch.utils.losses import jnp_maximum
from street_gaussians_torch.utils.quaternion import (
    quat_multiply,
    quat_normalize,
    quat_rotate,
    quat_to_rotmat,
)


# 180-degree rotation about the flip axis (y) as a quaternion
FLIP_QUAT = (0.0, 0.0, 1.0, 0.0)
FLIP_AXIS = 1


@dataclasses.dataclass
class SceneParams:
    """Every learnable tensor of the full model."""

    gaussians: G.GaussianParams
    actor_pose: Optional[ActorPoseParams]
    sky: Optional[SkyParams]
    color_correction: Optional[ColorCorrectionParams]
    pose_correction: Optional[PoseCorrectionParams]


@dataclasses.dataclass
class FrameInput:
    """Per-camera inputs for one render."""

    cam: Camera
    ego_quat: torch.Tensor  # [4] ego rotation quaternion
    ego_rotmat: torch.Tensor  # [3, 3]
    ego_trans: torch.Tensor  # [3]
    interp: Optional[ActorInterp]  # None when the scene has no actors


@dataclasses.dataclass(frozen=True)
class RenderOptions:
    """Static render configuration."""

    mode: str = "train"  # "train": flip + sky jitter, unclipped rgb, full-res sky
    render_normal: bool = False
    use_semantic: bool = False
    white_background: bool = False
    scaling_modifier: float = 1.0
    tile_capacity: int = 1024
    instance_capacity: int = 2**21
    max_tiles_per_gaussian: Optional[int] = None
    # "logits": the blended semantic channels as they are; "probabilities":
    # an actor's channel through a sigmoid, and the blended channels as
    # log(normalised + 1e-8)
    semantic_mode: str = "logits"
    # eval only: sample the sky on a 1/N ray grid and upsample
    sky_downsample: int = 1
    corner_cull: bool = True


class RowsFromModels(torch.autograd.Function):
    """per_model[mid] whose gradient needs no scatter: model m owns the
    contiguous rows slices[m], so its gradient is a slice sum. Rows that
    the slices do not cover fall back to a one-hot product."""

    @staticmethod
    def forward(ctx, per_model, mid, slices):
        ctx.save_for_backward(mid)
        ctx.slices = slices
        ctx.num_models = per_model.shape[0]
        return per_model[mid]

    @staticmethod
    def backward(ctx, d_rows):
        (mid,) = ctx.saved_tensors
        slices = ctx.slices
        if d_rows.shape[0] == slices[-1][1] and slices[0][0] == 0:
            d_pm = torch.stack([d_rows[s:e].sum(dim=0) for s, e in slices])
        else:
            models = torch.arange(ctx.num_models, device=mid.device)
            d_pm = (mid[:, None] == models[None, :]).to(d_rows.dtype).t() @ d_rows
        return d_pm, None, None


def rows_from_models(
    per_model: torch.Tensor, mid: torch.Tensor, slices: Sequence[Tuple[int, int]]
) -> torch.Tensor:
    """per_model[mid]: per-model values broadcast to their rows, with the
    slice-sum gradient of RowsFromModels. slices: (start, end) per model."""
    return RowsFromModels.apply(per_model, mid, tuple(slices))


def draw_flip(table: G.SceneTable, mid: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """The train-time symmetry flip: row r flips with its model's
    flip_prob ([C] bool)."""
    u = torch.rand(mid.shape[0], generator=generator, device=generator.device).to(mid.device)
    return u < table.flip_prob[mid]


def draw_sky_jitter(H: int, W: int, generator: torch.Generator, device) -> torch.Tensor:
    """The train-time sky ray jitter, [H, W, 2] in [-0.5, 0.5)."""
    return (torch.rand((H, W, 2), generator=generator, device=generator.device) - 0.5).to(device)


def compose_frame(
    params: SceneParams,
    aux: G.GaussianAux,
    table: G.SceneTable,
    pose_data: Optional[ActorPoseData],
    frame_inp: FrameInput,
    step: int,
    opts: RenderOptions = RenderOptions(),
    flip: Optional[torch.Tensor] = None,
    include_mask: Optional[Union[np.ndarray, torch.Tensor]] = None,
):
    """World-space per-Gaussian attributes for one camera: a dict of
    means3d, scales, quats, opacity, shs, semantic, normals, visible (all
    [C, ...]; semantic [C, S] with opts.use_semantic and normals [C, 3]
    with opts.render_normal, else None).
    flip: optional [C] bool, the train-time symmetry flip (actor rows
    mirrored across the y axis of their box frame); train mode only.
    include_mask: optional [M] bool, the models to render (a tensor on
    the parameters' device is used as it is, numpy is copied there)."""
    g = params.gaussians
    mid = aux.model_id
    dev = g.xyz.device
    frame = frame_inp.cam.frame
    M = table.num_models

    in_range = (frame >= table.start_frame[mid]) & (frame <= table.end_frame[mid])
    visible = aux.alive & in_range
    if include_mask is not None:
        inc = torch.as_tensor(include_mask, dtype=torch.bool, device=mid.device)
        visible = visible & inc[mid]

    is_actor_row = (mid > 0) & (table.track_id[mid] >= 0)
    n_sky = 1 if table.sky_model >= 0 else 0

    if table.num_actors > 0 and frame_inp.interp is not None:
        a_quat, a_trans = actor_poses(
            pose_data, params.actor_pose, frame_inp.interp,
            frame_inp.ego_quat, frame_inp.ego_rotmat, frame_inp.ego_trans,
        )
        ident = torch.tensor([[1.0, 0.0, 0.0, 0.0]], device=dev)
        zero3 = torch.zeros((1, 3), device=dev)
        obj_quat = torch.cat([ident, a_quat] + [ident] * n_sky, dim=0)  # [M, 4]
        obj_trans = torch.cat([zero3, a_trans] + [zero3] * n_sky, dim=0)
    else:
        obj_quat = torch.tensor([1.0, 0.0, 0.0, 0.0], device=dev).expand(M, 4)
        obj_trans = torch.zeros((M, 3), device=dev)

    slices = [(int(a), int(b)) for a, b in table.slices]
    row_quat = rows_from_models(obj_quat, mid, slices)  # [C, 4]
    row_trans = rows_from_models(obj_trans, mid, slices)  # [C, 3]

    xyz_local, rot_local = g.xyz, g.rot
    if opts.mode == "train" and flip is not None:
        mirror = torch.ones(3, device=dev)
        mirror[FLIP_AXIS] = -1.0
        fq = torch.tensor(FLIP_QUAT, device=dev)
        xyz_local = torch.where(flip[:, None], xyz_local * mirror, xyz_local)
        rot_local = torch.where(flip[:, None], quat_multiply(fq[None, :], rot_local), rot_local)

    # local -> world (actors) / pose correction (background)
    xyz_world_actor = quat_rotate(row_quat, xyz_local) + row_trans
    rot_world_actor = quat_normalize(quat_multiply(row_quat, quat_normalize(rot_local)))
    if params.pose_correction is not None:
        pc_idx = frame_inp.cam.image_id
        xyz_bkgd = correct_gaussian_xyz(params.pose_correction, pc_idx, g.xyz)
        rot_bkgd = correct_gaussian_rotation(params.pose_correction, pc_idx, quat_normalize(g.rot))
    else:
        xyz_bkgd = g.xyz
        rot_bkgd = quat_normalize(g.rot)

    means3d = torch.where(is_actor_row[:, None], xyz_world_actor, xyz_bkgd)
    quats = torch.where(is_actor_row[:, None], rot_world_actor, rot_bkgd)

    scales = torch.exp(g.log_scale)
    if table.sky_model >= 0:
        # sky-as-Gaussians: project xyz to >= 2x the sphere radius and
        # clamp the scaling at the sphere radius
        is_sky = mid == table.sky_model
        c = torch.as_tensor(table.sphere_center, device=dev)
        d = torch.linalg.norm(means3d - c[None, :], dim=-1, keepdim=True)
        ratio = d / (2.0 * table.sphere_radius)
        xyz_sky = torch.where(
            ratio < 1.0, c[None, :] + (means3d - c[None, :]) / torch.clamp(ratio, min=1e-6), means3d
        )
        means3d = torch.where(is_sky[:, None], xyz_sky, means3d)
        scales = torch.where(is_sky[:, None], torch.clamp(scales, max=table.sphere_radius), scales)

    # 4D Fourier DC features
    t_norm = (frame - table.start_frame).to(torch.float32) / torch.clamp(
        (table.end_frame - table.start_frame).to(torch.float32), min=1.0
    )  # [M]
    t_row = (table.fourier_scale * t_norm)[mid]  # [C]
    basis = sh_utils.idft_basis(t_row, table.fourier_dim)  # [C, Fdim]
    # background rows use only coefficient 0
    bkgd_basis = torch.zeros_like(basis)
    bkgd_basis[:, 0] = 1.0
    basis = torch.where(is_actor_row[:, None], basis, bkgd_basis)
    dc = torch.einsum("cf,cfk->ck", basis, g.feat_dc)  # [C, 3]

    # SH band masking: per-model max degree + the global ramp
    max_deg = max(table.sh_degree_bkgd, table.sh_degree_obj)
    active = G.active_sh_degree(step, max_deg)
    deg_row = torch.where(
        is_actor_row,
        min(active, table.sh_degree_obj),
        min(active, table.sh_degree_bkgd),
    )  # [C]
    K = (max_deg + 1) ** 2
    band = torch.floor(torch.sqrt(torch.arange(1, K, dtype=torch.float32, device=dev))).to(torch.int64)
    rest_mask = (band[None, :] <= deg_row[:, None]).to(torch.float32)  # [C, K-1]
    rest = g.feat_rest * rest_mask[..., None]
    shs = torch.cat([dc[:, None, :], rest], dim=1)  # [C, K, 3]

    # semantics: the background's first S columns (zero-padded), an
    # actor's one channel in its class_label column
    semantic = None
    if opts.use_semantic:
        S = table.num_classes
        onehot = torch.nn.functional.one_hot(table.class_label[mid].to(torch.int64), S).to(torch.float32)
        obj_val = g.semantic[:, 0:1]
        if opts.semantic_mode == "probabilities":
            obj_val = torch.sigmoid(obj_val)
        sem_actor = onehot * obj_val
        if g.semantic.shape[1] >= S:
            sem_bkgd = g.semantic[:, :S]
        else:
            sem_bkgd = torch.nn.functional.pad(g.semantic, (0, S - g.semantic.shape[1]))
        semantic = torch.where(is_actor_row[:, None], sem_actor, sem_bkgd)

    # normals: the column of the rotation at the min-scale axis, turned
    # to face the camera
    normals = None
    if opts.render_normal:
        R = quat_to_rotmat(quats)  # [C, 3, 3]
        min_axis = torch.argmin(scales, dim=1)  # [C]
        normals = torch.take_along_dim(R, min_axis[:, None, None].expand(-1, 3, 1), dim=2)[..., 0]
        dir_pp = means3d - frame_inp.cam.cam_center[None, :]
        dir_pp = dir_pp / jnp_maximum(torch.linalg.norm(dir_pp, dim=-1, keepdim=True), 1e-12)
        dot = torch.sum(-dir_pp * normals, dim=-1, keepdim=True)
        normals = torch.where(dot >= 0, normals, -normals)

    return dict(
        means3d=means3d,
        scales=scales,
        quats=quats,
        opacity=torch.sigmoid(g.opacity_logit)[:, 0],
        shs=shs,
        semantic=semantic,
        normals=normals,
        visible=visible,
    )


def _upsample2x(img: torch.Tensor) -> torch.Tensor:
    """[h, w, 3] -> [2h, 2w, 3] bilinear with half-pixel alignment:
    out[2i] = 0.75 in[i] + 0.25 in[i-1], out[2i+1] = 0.75 in[i] +
    0.25 in[i+1] (clamped edges) per axis."""

    def up(a, axis):
        n = a.shape[axis]
        prev = torch.cat([a.narrow(axis, 0, 1), a.narrow(axis, 0, n - 1)], dim=axis)
        nxt = torch.cat([a.narrow(axis, 1, n - 1), a.narrow(axis, n - 1, 1)], dim=axis)
        even = 0.75 * a + 0.25 * prev
        odd = 0.75 * a + 0.25 * nxt
        out = torch.stack([even, odd], dim=axis + 1)
        shape = list(a.shape)
        shape[axis] *= 2
        return out.reshape(shape)

    return up(up(img, 0), 1)


def _upsample_bilinear(img: torch.Tensor, ds: int) -> torch.Tensor:
    """[h, w, 3] -> [ds h, ds w, 3] bilinear with half-pixel centres, as
    jax.image.resize(method="bilinear") upsamples: at the edges JAX
    renormalises the triangle weights over the pixels inside the image
    and torch clamps the sample position, and both put all the weight on
    the edge pixel."""
    x = img.permute(2, 0, 1)[None]
    up = torch.nn.functional.interpolate(x, scale_factor=ds, mode="bilinear", align_corners=False)
    return up[0].permute(1, 2, 0)


def screen_space(
    params: SceneParams,
    aux: G.GaussianAux,
    table: G.SceneTable,
    pose_data: Optional[ActorPoseData],
    frame_inp: FrameInput,
    step: int,
    opts: RenderOptions = RenderOptions(),
    flip: Optional[torch.Tensor] = None,
    mean2d_offset: Optional[torch.Tensor] = None,
    include_mask: Optional[Union[np.ndarray, torch.Tensor]] = None,
):
    """Per-Gaussian half of the render: compose + screen-space
    preprocess. Returns (screen, composed dict). mean2d_offset: optional
    [C, 2] zeros added to the screen means, whose gradient is the
    view-space mean gradient that densification collects."""
    cam = frame_inp.cam
    composed = compose_frame(params, aux, table, pose_data, frame_inp, step, opts, flip, include_mask)
    max_deg = max(table.sh_degree_bkgd, table.sh_degree_obj)
    screen = preprocess_gaussians(
        means3d=composed["means3d"],
        scales=composed["scales"],
        quats=composed["quats"],
        opacities=composed["opacity"],
        shs=composed["shs"],
        cam_w2c=cam.w2c,
        cam_full_proj=cam.full_proj,
        cam_center=cam.cam_center,
        H=cam.H,
        W=cam.W,
        focal_x=cam.focal_x,
        focal_y=cam.focal_y,
        tan_fovx=cam.tan_fovx,
        tan_fovy=cam.tan_fovy,
        sh_degree=max_deg,
        scale_modifier=opts.scaling_modifier,
        alive=composed["visible"],
        max_tiles_per_gaussian=opts.max_tiles_per_gaussian,
    )
    if mean2d_offset is not None:
        screen = screen._replace(mean2d=screen.mean2d + mean2d_offset)
    return screen, composed


def render_frame(
    params: SceneParams,
    aux: G.GaussianAux,
    table: G.SceneTable,
    pose_data: Optional[ActorPoseData],
    frame_inp: FrameInput,
    step: int,
    opts: RenderOptions = RenderOptions(),
    sky_table: Optional[torch.Tensor] = None,
    flip: Optional[torch.Tensor] = None,
    sky_jitter: Optional[torch.Tensor] = None,
    mean2d_offset: Optional[torch.Tensor] = None,
    absgrad_dummy: Optional[torch.Tensor] = None,
    include_mask: Optional[Union[np.ndarray, torch.Tensor]] = None,
    compose_sky: bool = True,
) -> Dict[str, torch.Tensor]:
    """Full render of one camera -> dict rgb/acc/depth/T/radii/...

    sky_table: optional precomputed build_sky_table(params.sky.cubemap),
    for serving (frozen parameters): skips the per-frame table build.
    Train mode: `flip` ([C] bool) and `sky_jitter` ([H, W, 2]), or
    neither (no flip, no jitter).
    mean2d_offset / absgrad_dummy: optional [C, 2] zeros whose gradients
    are the view-space mean gradient and its per-pixel-abs (AbsGS) sum.
    include_mask: optional [M] bool, the models to render.
    compose_sky: False leaves the sky out."""
    cam = frame_inp.cam
    train = opts.mode == "train"
    sky = params.sky if compose_sky else None
    with record_function("screen_space"):
        screen, composed = screen_space(
            params, aux, table, pose_data, frame_inp, step, opts, flip, mean2d_offset, include_mask
        )
    dev = screen.depth.device
    # extra blend channels: normals first, then semantics
    extras = [composed[k] for k in ("normals", "semantic") if composed[k] is not None]
    bg = torch.full((3,), 1.0 if opts.white_background else 0.0, device=dev)
    out = rasterize(
        screen,
        cam.H,
        cam.W,
        bg_color=bg,
        extra_features=torch.cat(extras, dim=-1) if extras else None,
        config=RasterizeConfig(
            # falsy tile_capacity = uncapped
            tile_capacity=opts.tile_capacity or opts.instance_capacity,
            instance_capacity=opts.instance_capacity,
            corner_cull=opts.corner_cull,
        ),
        absgrad_dummy=absgrad_dummy,
    )

    if sky is not None:
        ds = opts.sky_downsample if not train else 1
        with record_function("sky"):
            sky_rgb = render_sky(
                sky, cam, downsample=ds, table=sky_table,
                jitter=sky_jitter if train else None,
            )
            if ds == 2:
                sky_rgb = _upsample2x(sky_rgb)[: cam.H, : cam.W]
            elif ds > 1:
                sky_rgb = _upsample_bilinear(sky_rgb, ds)[: cam.H, : cam.W]
            out["rgb"] = out["rgb"] + sky_rgb * out["T"][..., None]

    if params.color_correction is not None:
        out["rgb"] = apply_color_correction(params.color_correction, cam.image_id, out["rgb"])

    if not train:
        out["rgb"] = torch.clamp(out["rgb"], 0.0, 1.0)

    if extras:
        planes = out.pop("extra")
        offset = 0
        if composed["normals"] is not None:
            n = planes[..., 0:3]
            out["normals"] = n / jnp_maximum(torch.linalg.norm(n, dim=-1, keepdim=True), 1e-8)
            offset = 3
        if composed["semantic"] is not None:
            sem = planes[..., offset:]
            if opts.semantic_mode == "probabilities":
                sem = sem / (torch.sum(sem, dim=-1, keepdim=True) + 1e-8)
                sem = torch.log(sem + 1e-8)
            out["semantic"] = sem

    out["radii"] = screen.radius
    out["visibility"] = screen.radius > 0
    return out


def include_mask_for(table: G.SceneTable, include=None, exclude=None) -> np.ndarray:
    """[M] bool from lists of model names to include and to exclude."""
    m = np.ones(table.num_models, bool)
    if include is not None:
        m[:] = False
        for name in include:
            if name in table.names:
                m[table.names.index(name)] = True
    if exclude is not None:
        for name in exclude:
            if name in table.names:
                m[table.names.index(name)] = False
    return m


def render_object_mask(table: G.SceneTable) -> np.ndarray:
    """The actors alone: neither the background nor the sky model."""
    m = np.ones(table.num_models, bool)
    m[0] = False
    if table.sky_model >= 0:
        m[table.sky_model] = False
    return m


def render_background_mask(table: G.SceneTable) -> np.ndarray:
    """The background alone."""
    m = np.zeros(table.num_models, bool)
    m[0] = True
    return m
