"""Composite scene-graph renderer, forward.

Port of street_gaussians_tpu/models/renderer.py: one vectorized compose
over the packed Gaussian buffer (per-row gathers of per-model pose and
metadata), then preprocess -> binning -> tile blend, then sky cubemap
compositing and color correction. Per-frame visibility (actor lifetime,
include masks) goes through the `alive` mask; shapes never change.

Not ported yet: the train-time flip and sky jitter (they need a
torch.Generator and come with the training slice), semantics, normals,
include masks (render_object / render_background), tile-row sharding
and sky_downsample > 2.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

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
from street_gaussians_torch.utils.quaternion import (
    quat_multiply,
    quat_normalize,
    quat_rotate,
)


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

    mode: str = "train"  # "train" keeps the unclipped rgb and the full-res sky
    render_normal: bool = False
    use_semantic: bool = False
    white_background: bool = False
    scaling_modifier: float = 1.0
    tile_capacity: int = 1024
    instance_capacity: int = 2**21
    max_tiles_per_gaussian: Optional[int] = None
    # eval only: sample the sky on a 1/N ray grid and upsample (1 or 2)
    sky_downsample: int = 1
    corner_cull: bool = True


def rows_from_models(per_model: torch.Tensor, mid: torch.Tensor) -> torch.Tensor:
    """per_model[mid]: per-model values broadcast to their rows. (The
    JAX version's scatter-free gradient comes with the training slice.)"""
    return per_model[mid]


def compose_frame(
    params: SceneParams,
    aux: G.GaussianAux,
    table: G.SceneTable,
    pose_data: Optional[ActorPoseData],
    frame_inp: FrameInput,
    step: int,
    opts: RenderOptions = RenderOptions(),
):
    """World-space per-Gaussian attributes for one camera: a dict of
    means3d, scales, quats, opacity, shs, visible (all [C, ...])."""
    if opts.use_semantic or opts.render_normal:
        raise NotImplementedError("semantics and normals are not ported yet")
    g = params.gaussians
    mid = aux.model_id
    dev = g.xyz.device
    frame = frame_inp.cam.frame
    M = table.num_models

    in_range = (frame >= table.start_frame[mid]) & (frame <= table.end_frame[mid])
    visible = aux.alive & in_range

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

    row_quat = rows_from_models(obj_quat, mid)  # [C, 4]
    row_trans = rows_from_models(obj_trans, mid)  # [C, 3]

    # local -> world (actors) / pose correction (background)
    xyz_world_actor = quat_rotate(row_quat, g.xyz) + row_trans
    rot_world_actor = quat_normalize(quat_multiply(row_quat, quat_normalize(g.rot)))
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

    return dict(
        means3d=means3d,
        scales=scales,
        quats=quats,
        opacity=torch.sigmoid(g.opacity_logit)[:, 0],
        shs=shs,
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


def screen_space(
    params: SceneParams,
    aux: G.GaussianAux,
    table: G.SceneTable,
    pose_data: Optional[ActorPoseData],
    frame_inp: FrameInput,
    step: int,
    opts: RenderOptions = RenderOptions(),
):
    """Per-Gaussian half of the render: compose + screen-space
    preprocess. Returns (screen, composed dict)."""
    cam = frame_inp.cam
    composed = compose_frame(params, aux, table, pose_data, frame_inp, step, opts)
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
) -> Dict[str, torch.Tensor]:
    """Full render of one camera -> dict rgb/acc/depth/T/radii/...

    sky_table: optional precomputed build_sky_table(params.sky.cubemap),
    for serving (frozen parameters): skips the per-frame table build."""
    cam = frame_inp.cam
    with record_function("screen_space"):
        screen, _ = screen_space(params, aux, table, pose_data, frame_inp, step, opts)
    dev = screen.depth.device
    bg = torch.full((3,), 1.0 if opts.white_background else 0.0, device=dev)
    out = rasterize(
        screen,
        cam.H,
        cam.W,
        bg_color=bg,
        config=RasterizeConfig(
            # falsy tile_capacity = uncapped
            tile_capacity=opts.tile_capacity or opts.instance_capacity,
            instance_capacity=opts.instance_capacity,
            corner_cull=opts.corner_cull,
        ),
    )

    if params.sky is not None:
        ds = opts.sky_downsample if opts.mode != "train" else 1
        if ds not in (1, 2):
            raise NotImplementedError(f"sky_downsample={ds} is not ported yet (1 or 2)")
        with record_function("sky"):
            sky_rgb = render_sky(params.sky, cam, downsample=ds, table=sky_table)
            if ds == 2:
                sky_rgb = _upsample2x(sky_rgb)[: cam.H, : cam.W]
            out["rgb"] = out["rgb"] + sky_rgb * out["T"][..., None]

    if params.color_correction is not None:
        out["rgb"] = apply_color_correction(params.color_correction, cam.image_id, out["rgb"])

    if opts.mode != "train":
        out["rgb"] = torch.clamp(out["rgb"], 0.0, 1.0)

    out["radii"] = screen.radius
    out["visibility"] = screen.radius > 0
    return out
