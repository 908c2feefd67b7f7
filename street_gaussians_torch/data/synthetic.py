"""Synthetic street scenes for tests, serving and the chip smoke run.

Port of street_gaussians_tpu/data/synthetic.py: a background point shell
(ground + back wall), moving box actors with dense tracklets, and a row
of cameras, built in numpy with the same draws in the same order, so a
seed gives the JAX package's scene.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from street_gaussians_torch._device import resolve_device
from street_gaussians_torch.models import gaussians as G
from street_gaussians_torch.models.actor_pose import (
    ActorPoseData,
    ActorPoseParams,
    build_interp_table,
    init_actor_pose,
)
from street_gaussians_torch.models.renderer import FrameInput
from street_gaussians_torch.utils.camera import make_camera


@dataclasses.dataclass
class SyntheticScene:
    params_init: G.GaussianParams
    aux: G.GaussianAux
    table: G.SceneTable
    pose_data: Optional[ActorPoseData]
    pose_params_init: Optional[ActorPoseParams]
    frames: List[FrameInput]  # one per camera
    tracklets: np.ndarray
    timestamps: np.ndarray


def _yaw_quat(theta: float) -> np.ndarray:
    return np.array([np.cos(theta / 2.0), 0.0, 0.0, np.sin(theta / 2.0)], np.float32)


def look_at_w2c(eye: np.ndarray, target: np.ndarray, up=np.array([0, 0, 1.0])):
    """4x4 world->camera with +z forward, +x right, +y down."""
    f = target - eye
    f = f / np.linalg.norm(f)
    r = np.cross(f, up)
    r = r / np.linalg.norm(r)
    d = np.cross(f, r)  # down
    R = np.stack([r, d, f], axis=0)  # rows = camera axes in world
    t = -R @ eye
    m = np.eye(4, dtype=np.float32)
    m[:3, :3] = R
    m[:3, 3] = t
    return m


def make_synthetic_scene(
    num_bkgd: int = 400,
    num_frames: int = 8,
    num_actors: int = 1,
    H: int = 64,
    W: int = 96,
    seed: int = 0,
    device=None,
    **pack_kwargs,
) -> SyntheticScene:
    device = resolve_device(device)
    rng = np.random.default_rng(seed)

    ground = np.stack(
        [
            rng.uniform(-10, 10, num_bkgd // 2),
            rng.uniform(-10, 10, num_bkgd // 2),
            rng.uniform(-0.2, 0.2, num_bkgd // 2),
        ],
        axis=-1,
    )
    wall = np.stack(
        [
            rng.uniform(-10, 10, num_bkgd - num_bkgd // 2),
            np.full(num_bkgd - num_bkgd // 2, 10.0),
            rng.uniform(0, 5, num_bkgd - num_bkgd // 2),
        ],
        axis=-1,
    )
    bkgd_pts = np.concatenate([ground, wall]).astype(np.float32)
    bkgd_rgb = rng.uniform(0.2, 0.9, (num_bkgd, 3)).astype(np.float32)

    model_points = {"background": bkgd_pts}
    model_colors = {"background": bkgd_rgb}
    obj_meta = {}

    # actors: boxes moving along +x
    max_obj = max(num_actors, 1)
    tracklets = np.zeros((num_frames, max_obj, 8), np.float32)
    tracklets[..., 0] = -1.0
    timestamps = np.linspace(0.0, 1.0, num_frames).astype(np.float32)

    for a in range(num_actors):
        tid = 10 + a
        nm = f"obj_{tid:03d}"
        npts = 80
        box = np.array([2.0, 1.0, 0.8], np.float32)
        pts = rng.uniform(-0.5, 0.5, (npts, 3)).astype(np.float32) * box[None, :]
        cols = rng.uniform(0.3, 1.0, (npts, 3)).astype(np.float32)
        model_points[nm] = pts
        model_colors[nm] = cols
        obj_meta[tid] = dict(
            class_label=a % 4,
            deformable=False,
            start_frame=0,
            end_frame=num_frames - 1,
            length=float(box[0]),
            width=float(box[1]),
            height=float(box[2]),
            random_init=False,
        )
        for f in range(num_frames):
            x = -4.0 + 8.0 * f / max(num_frames - 1, 1)
            tracklets[f, a, 0] = tid
            tracklets[f, a, 1:4] = [x, -2.0 + a * 2.0, 0.5]
            tracklets[f, a, 4:8] = _yaw_quat(0.1 * f)

    params, aux, table = G.pack_scene(
        model_points,
        model_colors,
        obj_meta=obj_meta,
        scene_radius=12.0,
        sphere_radius=15.0,
        device=device,
        **pack_kwargs,
    )

    if num_actors > 0:
        pose_data, pose_params = init_actor_pose(tracklets, device=device)
        actor_tids = [int(t) for t in table.track_id.cpu().numpy() if int(t) >= 0]
    else:
        pose_data, pose_params = None, None
        actor_tids = []

    # cameras: looking at the scene center from -y
    K = np.array([[80.0, 0, W / 2.0], [0, 80.0, H / 2.0], [0, 0, 1]], np.float32)
    frames = []
    for f in range(num_frames):
        eye = np.array([0.0 + 0.3 * f, -9.0, 1.5], np.float32)
        w2c = look_at_w2c(eye, np.array([0.0, 0.0, 1.0]))
        cam = make_camera(
            K, w2c, H, W, frame=f, timestamp=float(timestamps[f]), image_id=f, device=device
        )
        ego = np.eye(4, dtype=np.float32)  # tracklets already in world frame
        if num_actors > 0:
            interp = build_interp_table(
                tracklets,
                timestamps,
                actor_tids,
                timestamp=float(timestamps[f]),
                is_val=False,
                train_timestamps_in_range=lambda tid: timestamps,
                opt_track=True,
                device=device,
            )
        else:
            interp = None
        frames.append(
            FrameInput(
                cam=cam,
                ego_quat=torch.tensor([1.0, 0.0, 0.0, 0.0], device=device),
                ego_rotmat=torch.as_tensor(ego[:3, :3].copy(), device=device),
                ego_trans=torch.as_tensor(ego[:3, 3].copy(), device=device),
                interp=interp,
            )
        )

    return SyntheticScene(
        params_init=params,
        aux=aux,
        table=table,
        pose_data=pose_data,
        pose_params_init=pose_params,
        frames=frames,
        tracklets=tracklets,
        timestamps=timestamps,
    )
