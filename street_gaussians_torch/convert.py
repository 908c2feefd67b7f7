"""Carry a scene and its frames across from the JAX package.

The JAX package's dataclasses arrive as nested dicts of numpy arrays and
Python scalars, keyed by dataclass field name (the caller flattens them;
this module never sees a JAX type), and leave as the port's objects on a
given device. Integer index tensors become int64, as torch indexing
wants; everything else keeps its dtype.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from street_gaussians_torch.models import gaussians as G
from street_gaussians_torch.models.actor_pose import (
    ActorInterp,
    ActorPoseData,
    ActorPoseParams,
)
from street_gaussians_torch.models.corrections import (
    ColorCorrectionParams,
    PoseCorrectionParams,
)
from street_gaussians_torch.models.renderer import FrameInput, SceneParams
from street_gaussians_torch.models.sky_cubemap import SkyParams
from street_gaussians_torch.utils.camera import Camera

# fields that index other tensors
_INDEX_FIELDS = {"model_id", "frame_idx", "col_idx"}
# SceneTable fields the port keeps as numpy / Python values
_HOST_FIELDS = {"names", "slices", "scene_center", "sphere_center"}


def _build(cls, d: Optional[dict], device):
    if d is None:
        return None
    kw = {}
    for f in dataclasses.fields(cls):
        v = d[f.name]
        if f.name in _HOST_FIELDS:
            v = list(v) if f.name == "names" else np.asarray(v)
        elif isinstance(v, np.ndarray) and v.ndim > 0:
            t = torch.as_tensor(np.array(v), device=device)
            v = t.to(torch.int64) if f.name in _INDEX_FIELDS else t
        else:  # static scalars
            v = v.item() if isinstance(v, np.ndarray | np.generic) else v
        kw[f.name] = v
    return cls(**kw)


def scene_from_numpy(params: dict, aux: dict, table: dict, pose_data: Optional[dict], device):
    """(SceneParams, GaussianAux, SceneTable, ActorPoseData or None) on
    `device` from the JAX package's objects flattened to dicts."""
    scene_params = SceneParams(
        gaussians=_build(G.GaussianParams, params["gaussians"], device),
        actor_pose=_build(ActorPoseParams, params.get("actor_pose"), device),
        sky=_build(SkyParams, params.get("sky"), device),
        color_correction=_build(ColorCorrectionParams, params.get("color_correction"), device),
        pose_correction=_build(PoseCorrectionParams, params.get("pose_correction"), device),
    )
    return (
        scene_params,
        _build(G.GaussianAux, aux, device),
        _build(G.SceneTable, table, device),
        _build(ActorPoseData, pose_data, device),
    )


def frame_from_numpy(frame: dict, device) -> FrameInput:
    """A FrameInput (camera plus ActorInterp) on `device`."""
    cam = frame["cam"]
    t = lambda a: torch.as_tensor(np.array(a, np.float32), device=device)  # noqa: E731
    return FrameInput(
        cam=Camera(
            w2c=t(cam["w2c"]),
            proj=t(cam["proj"]),
            cam_center=t(cam["cam_center"]),
            K=t(cam["K"]),
            H=int(cam["H"]),
            W=int(cam["W"]),
            frame=int(cam["frame"]),
            timestamp=float(cam["timestamp"]),
            cam_id=int(cam["cam_id"]),
            image_id=int(cam["image_id"]),
        ),
        ego_quat=t(frame["ego_quat"]),
        ego_rotmat=t(frame["ego_rotmat"]),
        ego_trans=t(frame["ego_trans"]),
        interp=_build(ActorInterp, frame.get("interp"), device),
    )
