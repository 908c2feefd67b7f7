"""Packed fixed-capacity Gaussian scene state.

Port of street_gaussians_tpu/models/gaussians.py. All Gaussians of a
scene live in one set of packed tensors of static capacity; each
sub-model (background, actors, optional sky-as-Gaussians) owns a
contiguous row slice, and a per-row `model_id` plus a small per-model
`SceneTable` replace a registry of per-object clouds. Model 0 is the
background; actor xyz / rotation are in the canonical box frame.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from street_gaussians_torch._device import resolve_device
from street_gaussians_torch.utils import knn as knn_utils
from street_gaussians_torch.utils import sh as sh_utils


def inverse_sigmoid(x):
    return np.log(x / (1.0 - x))


@dataclasses.dataclass
class GaussianParams:
    """The learnable tensors. All leading dims = capacity C."""

    xyz: torch.Tensor  # [C, 3]
    feat_dc: torch.Tensor  # [C, Fdim, 3]
    feat_rest: torch.Tensor  # [C, K-1, 3] higher SH bands
    log_scale: torch.Tensor  # [C, 3]
    rot: torch.Tensor  # [C, 4] unnormalized quaternion (w, x, y, z)
    opacity_logit: torch.Tensor  # [C, 1]
    semantic: torch.Tensor  # [C, S] (S = 1 when semantics are off)


@dataclasses.dataclass
class GaussianAux:
    """Non-learnable per-row state (alive mask + densification stats)."""

    alive: torch.Tensor  # [C] bool
    model_id: torch.Tensor  # [C] int64 (an index)
    grad_accum: torch.Tensor  # [C, 2]
    denom: torch.Tensor  # [C]
    max_radii: torch.Tensor  # [C]


@dataclasses.dataclass(frozen=True)
class SceneTable:
    """Per-model metadata. numpy arrays and Python scalars describe the
    layout; the tensors are gathered per row on the render device.
    M = number of models."""

    names: List[str]
    slices: np.ndarray  # [M, 2] int (start, end) row ranges
    capacity: int

    track_id: torch.Tensor  # [M] (-1 background, -2 sky)
    class_label: torch.Tensor  # [M]
    deformable: torch.Tensor  # [M] bool
    random_init: torch.Tensor  # [M] bool
    start_frame: torch.Tensor  # [M]
    end_frame: torch.Tensor  # [M]
    extent: torch.Tensor  # [M]
    spatial_lr_scale: torch.Tensor  # [M]
    flip_prob: torch.Tensor  # [M]
    bbox_half: torch.Tensor  # [M, 3]
    fourier_scale: float

    scene_center: np.ndarray  # [3]
    scene_radius: float
    sphere_center: np.ndarray  # [3]
    sphere_radius: float
    sh_degree_bkgd: int
    sh_degree_obj: int
    fourier_dim: int
    num_classes: int
    use_semantic: bool
    sky_model: int = -1  # index of the sky-as-Gaussians model, or -1

    @property
    def num_models(self) -> int:
        return len(self.names)

    @property
    def num_actors(self) -> int:
        return self.num_models - 1 - (1 if self.sky_model >= 0 else 0)


def _round_up(n: int, r: int) -> int:
    return ((n + r - 1) // r) * r


def pack_scene(
    model_points: Dict[str, np.ndarray],
    model_colors: Dict[str, np.ndarray],
    obj_meta: Optional[Dict] = None,
    scene_center=np.zeros(3),
    scene_radius: float = 20.0,
    sphere_center=np.zeros(3),
    sphere_radius: float = 20.0,
    sh_degree_bkgd: int = 3,
    sh_degree_obj: int = 3,
    fourier_dim: int = 1,
    fourier_scale: float = 1.0,
    flip_prob: float = 0.0,
    num_classes: int = 20,
    use_semantic: bool = False,
    background_growth: float = 4.0,
    actor_growth: float = 4.0,
    round_to: int = 256,
    box_scale: float = 1.0,
    spatial_lr_scale_bkgd: Optional[float] = None,
    sky_points: Optional[np.ndarray] = None,
    sky_colors: Optional[np.ndarray] = None,
    device=None,
):
    """Pack initial per-model point clouds into (params, aux, table) on
    `device`: SH-DC from RGB, log-sqrt-3NN scales, identity rotation,
    opacity 0.1. Same layout as the JAX package's pack_scene."""
    device = resolve_device(device)
    obj_meta = obj_meta or {}
    names = ["background"] + [n for n in model_points.keys() if n != "background"]
    if sky_points is not None:
        model_points = dict(model_points)
        model_colors = dict(model_colors)
        model_points["sky"] = np.asarray(sky_points, np.float32)
        model_colors["sky"] = np.asarray(sky_colors, np.float32)
        names = [n for n in names if n != "sky"] + ["sky"]

    slices = []
    cursor = 0
    for name in names:
        n = model_points[name].shape[0]
        growth = background_growth if name == "background" else actor_growth
        cap = _round_up(max(int(n * growth), round_to), round_to)
        slices.append((cursor, cursor + cap))
        cursor += cap
    capacity = cursor
    slices = np.array(slices, np.int64)

    K = (max(sh_degree_bkgd, sh_degree_obj) + 1) ** 2
    S = num_classes if use_semantic else 1
    Fdim = max(fourier_dim, 1)

    xyz = np.zeros((capacity, 3), np.float32)
    feat_dc = np.zeros((capacity, Fdim, 3), np.float32)
    feat_rest = np.zeros((capacity, K - 1, 3), np.float32)
    log_scale = np.full((capacity, 3), -10.0, np.float32)
    rot = np.zeros((capacity, 4), np.float32)
    rot[:, 0] = 1.0
    opacity_logit = np.full((capacity, 1), -10.0, np.float32)
    semantic = np.zeros((capacity, S), np.float32)
    alive = np.zeros((capacity,), bool)
    model_id = np.zeros((capacity,), np.int64)

    cols = {k: [] for k in (
        "track_id", "class_label", "deformable", "random_init", "start_frame",
        "end_frame", "extent", "spatial_lr_scale", "flip_prob", "bbox_half",
    )}

    for mi, name in enumerate(names):
        s, e = slices[mi]
        model_id[s:e] = mi
        pts = np.asarray(model_points[name], np.float32)
        clr = np.asarray(model_colors[name], np.float32)
        n = pts.shape[0]
        xyz[s : s + n] = pts
        feat_dc[s : s + n, 0] = sh_utils.rgb_to_sh(clr)
        if n > 0:
            log_scale[s : s + n] = knn_utils.initial_log_scales(pts)
        opacity_logit[s : s + n] = inverse_sigmoid(0.1)
        alive[s : s + n] = True

        if name in ("background", "sky"):
            bkgd = name == "background"
            row = dict(
                track_id=-1 if bkgd else -2, class_label=0, deformable=False,
                random_init=False, start_frame=0, end_frame=1 << 30,
                extent=scene_radius if bkgd else sphere_radius,
                spatial_lr_scale=(
                    (scene_radius if spatial_lr_scale_bkgd is None else spatial_lr_scale_bkgd)
                    if bkgd else sphere_radius
                ),
                flip_prob=0.0, bbox_half=[0.0, 0.0, 0.0],
            )
        else:
            tid = int(name.split("_")[-1])
            meta = obj_meta.get(tid, {})
            length = float(meta.get("length", 4.0))
            width = float(meta.get("width", 2.0))
            height = float(meta.get("height", 1.6))
            ext = max(length * 1.5 / box_scale, width * 1.5 / box_scale, height) / 2.0
            deform = bool(meta.get("deformable", False))
            row = dict(
                track_id=tid, class_label=int(meta.get("class_label", 0)),
                deformable=deform, random_init=bool(meta.get("random_init", False)),
                start_frame=int(meta.get("start_frame", 0)),
                end_frame=int(meta.get("end_frame", 1 << 30)),
                extent=ext, spatial_lr_scale=ext,
                flip_prob=0.0 if deform else flip_prob,
                bbox_half=[length / 2.0, width / 2.0, height / 2.0],
            )
        for k, v in row.items():
            cols[k].append(v)

    t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    params = GaussianParams(
        xyz=t(xyz), feat_dc=t(feat_dc), feat_rest=t(feat_rest),
        log_scale=t(log_scale), rot=t(rot), opacity_logit=t(opacity_logit),
        semantic=t(semantic),
    )
    aux = GaussianAux(
        alive=t(alive),
        model_id=t(model_id),
        grad_accum=torch.zeros((capacity, 2), device=device),
        denom=torch.zeros((capacity,), device=device),
        max_radii=torch.zeros((capacity,), device=device),
    )
    i32 = lambda k: t(np.array(cols[k], np.int32))  # noqa: E731
    f32 = lambda k: t(np.array(cols[k], np.float32))  # noqa: E731
    table = SceneTable(
        names=names,
        slices=slices,
        capacity=capacity,
        track_id=i32("track_id"),
        class_label=i32("class_label"),
        deformable=t(np.array(cols["deformable"], bool)),
        random_init=t(np.array(cols["random_init"], bool)),
        start_frame=i32("start_frame"),
        end_frame=i32("end_frame"),
        extent=f32("extent"),
        spatial_lr_scale=f32("spatial_lr_scale"),
        flip_prob=f32("flip_prob"),
        bbox_half=f32("bbox_half"),
        fourier_scale=float(fourier_scale),
        scene_center=np.asarray(scene_center, np.float32),
        scene_radius=float(scene_radius),
        sphere_center=np.asarray(sphere_center, np.float32),
        sphere_radius=float(sphere_radius),
        sh_degree_bkgd=int(sh_degree_bkgd),
        sh_degree_obj=int(sh_degree_obj),
        fourier_dim=Fdim,
        num_classes=num_classes,
        use_semantic=use_semantic,
        sky_model=(len(names) - 1) if sky_points is not None else -1,
    )
    return params, aux, table


# activations


def get_scaling(params: GaussianParams) -> torch.Tensor:
    return torch.exp(params.log_scale)


def get_opacity(params: GaussianParams) -> torch.Tensor:
    return torch.sigmoid(params.opacity_logit)


def get_rotation(params: GaussianParams) -> torch.Tensor:
    n = torch.linalg.norm(params.rot, dim=-1, keepdim=True)
    return params.rot / torch.clamp(n, min=1e-12)


def active_sh_degree(step: int, max_degree: int) -> int:
    """SH degree ramp: +1 every 1000 iterations up to max."""
    return min(int(step) // 1000, max_degree)

