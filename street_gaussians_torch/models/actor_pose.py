"""Tracklet pose store + learnable refinement, vectorized over actors.

Port of street_gaussians_tpu/models/actor_pose.py. The nearest-timestamp
indices are precomputed once per camera (`build_interp_table`); the
render does a gather + slerp over all actors at once.

Kept deviation from the reference (its rots2 typo): the second sample
uses its own rotation and its own (frame, column) residual.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from street_gaussians_torch._device import resolve_device
from street_gaussians_torch.utils.quaternion import (
    quat_multiply,
    quat_normalize,
    quat_slerp,
)


@dataclasses.dataclass
class ActorPoseParams:
    """Learnable tracklet residuals."""

    opt_trans: torch.Tensor  # [F, O, 3]
    opt_rots: torch.Tensor  # [F, O, 1] yaw residual theta


@dataclasses.dataclass(frozen=True)
class ActorPoseData:
    """Frozen tracklet inputs. O = max objects per frame, F = frames."""

    input_trans: torch.Tensor  # [F, O, 3]
    input_rots: torch.Tensor  # [F, O, 4] (w, x, y, z)


@dataclasses.dataclass
class ActorInterp:
    """Per-camera interpolation table over the scene's A actors: 4
    tracklet samples per actor; ratios = (r_a, r_b, r)."""

    frame_idx: torch.Tensor  # [A, 4] int64 into F
    col_idx: torch.Tensor  # [A, 4] int64 into O
    ratios: torch.Tensor  # [A, 3] float32


def quat_multiply_theta(q: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """Right-multiply q by (cos θ, 0, 0, sin θ)."""
    aw, ax, ay, az = q.unbind(-1)
    bw = torch.cos(theta)
    bz = torch.sin(theta)
    return torch.stack(
        [aw * bw - az * bz, ax * bw + ay * bz, ay * bw - ax * bz, az * bw + aw * bz],
        dim=-1,
    )


def actor_poses(
    data: ActorPoseData,
    params: Optional[ActorPoseParams],
    interp: ActorInterp,
    ego_quat: torch.Tensor,
    ego_rotmat: torch.Tensor,
    ego_trans: torch.Tensor,
):
    """World-frame pose of every actor for one camera: (obj_quat [A, 4],
    obj_trans [A, 3]). params=None disables the residuals."""
    f = interp.frame_idx
    c = interp.col_idx
    trans_k = data.input_trans[f, c]  # [A, 4, 3]
    rots_k = data.input_rots[f, c]  # [A, 4, 4]
    if params is not None:
        trans_k = trans_k + params.opt_trans[f, c]
        rots_k = quat_multiply_theta(rots_k, params.opt_rots[f, c][..., 0])

    r_a = interp.ratios[:, 0:1]
    r_b = interp.ratios[:, 1:2]
    r = interp.ratios[:, 2:3]

    trans_a = trans_k[:, 0] * (1.0 - r_a) + trans_k[:, 1] * r_a
    trans_b = trans_k[:, 2] * (1.0 - r_b) + trans_k[:, 3] * r_b
    trans = trans_a * (1.0 - r) + trans_b * r

    q_a = quat_slerp(rots_k[:, 0], rots_k[:, 1], r_a)
    q_b = quat_slerp(rots_k[:, 2], rots_k[:, 3], r_b)
    quat = quat_slerp(q_a, q_b, r)

    world_quat = quat_normalize(quat_multiply(ego_quat[None, :], quat))
    world_trans = trans @ ego_rotmat.T + ego_trans[None, :]
    return world_quat, world_trans


# host-side table construction


def _bracket(track_rows: np.ndarray, row_ts: np.ndarray, t: float):
    """Two tracklet rows nearest in time to t, + lerp ratio."""
    d = np.abs(row_ts - t)
    i1, i2 = np.argsort(d, kind="stable")[:2]
    t1, t2 = row_ts[i1], row_ts[i2]
    r = 0.0 if t2 == t1 else (t - t1) / (t2 - t1)
    return track_rows[i1], track_rows[i2], float(r)


def build_interp_table(
    tracklets: np.ndarray,  # [F, O, 8] (track_id, x, y, z, qw, qx, qy, qz)
    tracklet_timestamps: np.ndarray,  # [F]
    actor_track_ids: List[int],
    timestamp: float,
    is_val: bool,
    train_timestamps_in_range,  # track_id -> usable train cam timestamps
    opt_track: bool,
    device=None,
) -> ActorInterp:
    """One camera's ActorInterp (host-side numpy, then tensors)."""
    device = resolve_device(device)
    A = len(actor_track_ids)
    frame_idx = np.zeros((A, 4), np.int64)
    col_idx = np.zeros((A, 4), np.int64)
    ratios = np.zeros((A, 3), np.float32)

    track_ids = tracklets[..., 0]
    for a, tid in enumerate(actor_track_ids):
        rows = np.argwhere(track_ids == tid)  # [n, 2] (frame, col)
        if rows.shape[0] < 2:
            rows = np.repeat(rows, 2, axis=0) if rows.shape[0] == 1 else np.zeros((2, 2), np.int64)
        row_ts = tracklet_timestamps[rows[:, 0]]

        ts_pair = None
        if opt_track and is_val:
            cam_ts = np.asarray(train_timestamps_in_range(tid))
            if len(cam_ts) >= 2:
                d = np.abs(cam_ts - timestamp)
                j1, j2 = np.argsort(d, kind="stable")[:2]
                ts_pair = (float(cam_ts[j1]), float(cam_ts[j2]))

        if ts_pair is None:
            p1, p2, r_a = _bracket(rows, row_ts, timestamp)
            frame_idx[a] = [p1[0], p2[0], p1[0], p2[0]]
            col_idx[a] = [p1[1], p2[1], p1[1], p2[1]]
            ratios[a] = [r_a, r_a, 0.0]
        else:
            t_a, t_b = ts_pair
            pa1, pa2, r_a = _bracket(rows, row_ts, t_a)
            pb1, pb2, r_b = _bracket(rows, row_ts, t_b)
            r = 0.0 if t_b == t_a else (timestamp - t_a) / (t_b - t_a)
            frame_idx[a] = [pa1[0], pa2[0], pb1[0], pb2[0]]
            col_idx[a] = [pa1[1], pa2[1], pb1[1], pb2[1]]
            ratios[a] = [r_a, r_b, r]

    t = lambda x: torch.as_tensor(x, device=device)  # noqa: E731
    return ActorInterp(frame_idx=t(frame_idx), col_idx=t(col_idx), ratios=t(ratios))


def init_actor_pose(tracklets: np.ndarray, device=None):
    """(data, params) from the dense tracklet array."""
    device = resolve_device(device)
    tracklets = np.asarray(tracklets, np.float32)
    data = ActorPoseData(
        input_trans=torch.as_tensor(tracklets[..., 1:4].copy(), device=device),
        input_rots=torch.as_tensor(tracklets[..., 4:8].copy(), device=device),
    )
    F, O = tracklets.shape[0], tracklets.shape[1]
    params = ActorPoseParams(
        opt_trans=torch.zeros((F, O, 3), device=device),
        opt_rots=torch.zeros((F, O, 1), device=device),
    )
    return data, params
