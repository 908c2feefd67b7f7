"""Scene assembly: parser output -> the port's training structures.

Port of street_gaussians_tpu/data/dataset.py: builds the packed Gaussian
scene, one FrameInput per image (camera, ego pose, actor-interp tables)
and loads each view's GroundTruth with the reference's resize rules
(area-averaged images, nearest-neighbour guidance, 1600 px width cap),
all on `device`. Images go through utils/image_io, not cv2.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from street_gaussians_torch._device import resolve_device
from street_gaussians_torch.config import Config
from street_gaussians_torch.data import waymo
from street_gaussians_torch.models import gaussians as G
from street_gaussians_torch.models.actor_pose import (
    ActorPoseData,
    ActorPoseParams,
    build_interp_table,
    init_actor_pose,
)
from street_gaussians_torch.models.renderer import FrameInput
from street_gaussians_torch.train_lib import GroundTruth
from street_gaussians_torch.utils import ply as ply_utils
from street_gaussians_torch.utils.camera import make_camera
from street_gaussians_torch.utils.image_io import imread, resize_area, resize_nearest
from street_gaussians_torch.utils.pointcloud import nerfpp_norm, sphere_norm


@dataclasses.dataclass
class CameraView:
    """One image: its FrameInput plus host-side paths and metadata."""

    frame_input: FrameInput
    image_path: str
    H: int
    W: int
    cam: int  # sensor index
    frame: int  # absolute frame id
    frame_idx: int  # frame id relative to the selected range
    timestamp: float
    is_val: bool
    image_name: str
    sky_mask_path: Optional[str] = None
    lidar_depth_path: Optional[str] = None
    obj_bound: Optional[np.ndarray] = None  # full-resolution uint8/bool
    sky_scale: float = 1.0


@dataclasses.dataclass
class Scene:
    table: G.SceneTable
    params_init: G.GaussianParams
    aux_init: G.GaussianAux
    pose_data: Optional[ActorPoseData]
    pose_params_init: Optional[ActorPoseParams]
    train_views: List[CameraView]
    test_views: List[CameraView]
    metadata: Dict

    @property
    def all_views(self):
        return self.train_views + self.test_views


def _resize_shape(orig_w: int, orig_h: int, resolution_scale: float = 1.0, cap: int = 1600):
    """(W, H, scale) with the width capped at `cap` pixels."""
    scale = min(1.0, cap / orig_w) / resolution_scale
    return int(round(orig_w * scale)), int(round(orig_h * scale)), scale


def load_ground_truth(view: CameraView, white_background: bool = False, device=None) -> GroundTruth:
    """Read and resize the image and guidance of one view onto `device`.
    white_background is accepted for the reference's signature; the
    loaded images carry their own background."""
    device = resolve_device(device)
    H, W = view.H, view.W
    img = imread(view.image_path)[..., [2, 1, 0]].astype(np.float32) / 255.0
    if img.shape[:2] != (H, W):
        img = resize_area(img, (W, H))

    if view.sky_mask_path and os.path.exists(view.sky_mask_path):
        sky = resize_nearest(waymo.load_sky_mask(view.sky_mask_path), (W, H))
    else:
        sky = np.zeros((H, W), bool)

    if view.lidar_depth_path and os.path.exists(view.lidar_depth_path):
        depth = resize_nearest(waymo.load_lidar_depth(view.lidar_depth_path), (W, H))
    else:
        depth = np.zeros((H, W), np.float32)

    if view.obj_bound is not None:
        ob = resize_nearest(view.obj_bound.astype(bool), (W, H))
    else:
        ob = np.zeros((H, W), bool)

    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=device)  # noqa: E731
    return GroundTruth(
        image=t(img),
        mask=torch.ones((H, W, 1), dtype=torch.bool, device=device),
        sky_mask=t(sky[..., None]),
        lidar_depth=t(depth),
        obj_bound=t(ob[..., None]),
        sky_scale=torch.tensor(view.sky_scale, dtype=torch.float32, device=device),
    )


def load_waymo_scene(cfg: Config, device=None) -> Scene:
    """The whole Waymo-format scene build on `device`. Also serves
    `data.type: Kitti` (the same on-disk layout with 2 sensors). With
    cfg.mode == "train" it writes the input clouds under
    cfg.model_path/input_ply."""
    device = resolve_device(device)
    d = cfg.data
    path = cfg.source_path
    default_cams = [0, 1] if d.type == "Kitti" else [0, 1, 2]
    cameras = list(d.get("cameras", default_cams))
    selected = d.get("selected_frames", None)

    colmap_dir = os.path.join(cfg.model_path, "colmap/triangulated/sparse/model")
    out = waymo.generate_dataparser_outputs(
        path,
        selected_frames=selected,
        cameras=cameras,
        build_pointcloud=(cfg.mode == "train"),
        box_scale=d.get("box_scale", 1.0),
        use_tracker=d.get("use_tracker", False),
        colmap_model_dir=colmap_dir if d.get("use_colmap", True) else None,
        filter_colmap=d.get("filter_colmap", False),
        extent_for_colmap_filter=d.get("extent", 10) or 10,
        sphere_scale=d.get("sphere_scale", 1.0),
    )

    num_frames = out.num_frames
    train_frames, test_frames = waymo.get_val_frames(
        num_frames,
        test_every=d.split_test if d.split_test > 0 else None,
        train_every=d.split_train if d.split_train > 0 else None,
    )
    train_frame_set = set(train_frames)

    # per-sensor camera timestamp tables
    camera_timestamps = {c: {"train_timestamps": [], "test_timestamps": []} for c in cameras}
    for i in range(len(out.exts)):
        kind = "train_timestamps" if out.frames_idx[i] in train_frame_set else "test_timestamps"
        camera_timestamps[out.cams[i]][kind].append(float(out.cams_timestamps[i]))
    for c in cameras:
        camera_timestamps[c]["train_timestamps"].sort()
        camera_timestamps[c]["test_timestamps"].sort()

    # object lifetime timestamps
    min_ts = float(min(out.cams_timestamps.min(), out.tracklet_timestamps.min()))
    max_ts = float(max(out.cams_timestamps.max(), out.tracklet_timestamps.max()))
    sf = selected[0] if selected else 0
    for tid, obj in out.obj_info.items():
        s_idx = obj["start_frame"] - sf
        e_idx = obj["end_frame"] - sf
        obj["start_timestamp"] = max(out.tracklet_timestamps[s_idx] - 0.1, min_ts)
        obj["end_timestamp"] = min(out.tracklet_timestamps[e_idx] + 0.1, max_ts)

    # scene norm
    cam_centers = out.c2ws[:, :3, 3]
    train_mask = np.array([fi in train_frame_set for fi in out.frames_idx])
    scene_center, scene_radius = nerfpp_norm(cam_centers[train_mask])
    scene_radius = max(scene_radius, 10.0)
    if d.get("extent"):
        scene_radius = float(d.extent)

    lidar_pts = out.points_xyz_dict.get("lidar")
    if lidar_pts is not None and len(lidar_pts):
        sphere_center, sphere_radius = sphere_norm(lidar_pts, d.get("sphere_scale", 1.0))
    else:
        sphere_center, sphere_radius = scene_center, scene_radius

    # the packed scene
    mg = cfg.model.gaussian
    sh_deg = mg.sh_degree
    flip_prob = mg.get("flip_prob", 0.0)

    model_points = {"background": out.points_xyz_dict.get("bkgd", np.zeros((0, 3), np.float32))}
    model_colors = {"background": out.points_rgb_dict.get("bkgd", np.zeros((0, 3), np.float32))}
    obj_meta = {}
    for tid, obj in out.obj_info.items():
        name = f"obj_{tid:03d}"
        pts = out.points_xyz_dict.get(name, np.zeros((0, 3), np.float32))
        cols = out.points_rgb_dict.get(name, np.zeros((0, 3), np.float32))
        random_init = pts.shape[0] < 2000
        if random_init:
            bbox = np.array([obj["length"], obj["width"], obj["height"]], np.float32)
            pts, cols = G.make_actor_grid_points(bbox)
        elif not obj["deformable"] and flip_prob > 0.0:
            pts, cols = G.mirror_points(pts, cols)
        model_points[name] = pts
        model_colors[name] = cols
        obj_meta[tid] = dict(
            class_label=max(obj["class_label"], 0),
            deformable=obj["deformable"],
            start_frame=obj["start_frame"],
            end_frame=obj["end_frame"],
            length=obj["length"],
            width=obj["width"],
            height=obj["height"],
            random_init=random_init,
        )

    # optional sky-as-Gaussians model from points3D_sky.ply
    sky_pts, sky_cols = None, None
    if cfg.model.nsg.get("include_sky_gaussians", False):
        sky_ply = os.path.join(cfg.model_path, "input_ply", "points3D_sky.ply")
        if os.path.exists(sky_ply):
            sky_pts, sky_cols, _ = ply_utils.read_points_ply(sky_ply)

    params, aux, table = G.pack_scene(
        model_points,
        model_colors,
        sky_points=sky_pts,
        sky_colors=sky_cols,
        obj_meta=obj_meta,
        scene_center=scene_center,
        scene_radius=scene_radius,
        sphere_center=sphere_center,
        sphere_radius=sphere_radius,
        sh_degree_bkgd=mg.get("sh_degree_background", sh_deg),
        sh_degree_obj=mg.get("sh_degree_obj", sh_deg),
        fourier_dim=mg.get("fourier_dim", 1),
        fourier_scale=mg.get("fourier_scale", 1.0),
        flip_prob=flip_prob,
        num_classes=d.get("num_classes", 20),
        use_semantic=d.get("use_semantic", False),
        background_growth=cfg.capacity.background_growth,
        actor_growth=cfg.capacity.actor_growth,
        round_to=cfg.capacity.round_to,
        box_scale=d.get("box_scale", 1.0),
        device=device,
    )

    # the actor pose module
    if table.num_models > 1:
        pose_data, pose_params = init_actor_pose(out.obj_tracklets, device=device)
        actor_tids = [int(t) for t in table.track_id.tolist() if int(t) >= 0]
    else:
        pose_data, pose_params = None, None
        actor_tids = []

    opt_track = cfg.model.nsg.get("opt_track", True)
    sky_scales = list(cfg.optim.get("lambda_sky_scale", []))

    # one view per image
    train_views, test_views = [], []
    sky_dir = os.path.join(path, "sky_mask")
    depth_dir = os.path.join(path, "lidar_depth")
    for i in range(len(out.exts)):
        cam_sensor = out.cams[i]
        orig_h, orig_w = out.sensor_sizes[cam_sensor]
        W, H, scale = _resize_shape(orig_w, orig_h)
        K = out.ixts[i].copy()
        K[:2] *= scale
        w2c = np.linalg.inv(out.c2ws[i])
        is_val = out.frames_idx[i] not in train_frame_set
        ts = float(out.cams_timestamps[i])

        cam = make_camera(
            K, w2c, H, W, frame=out.frames[i], timestamp=ts, cam_id=cam_sensor, image_id=i,
            device=device,
        )
        pose = out.poses[i]
        ego_quat = waymo.rotmat_to_quat_np(pose[:3, :3])

        if actor_tids:
            def train_ts_in_range(tid, _cam=cam_sensor):
                obj = out.obj_info[tid]
                ts_list = camera_timestamps[_cam]["train_timestamps"]
                return np.array(
                    [t for t in ts_list if obj["start_timestamp"] <= t <= obj["end_timestamp"]]
                )

            interp = build_interp_table(
                out.obj_tracklets,
                out.tracklet_timestamps,
                actor_tids,
                timestamp=ts,
                is_val=is_val,
                train_timestamps_in_range=train_ts_in_range,
                opt_track=opt_track,
                device=device,
            )
        else:
            interp = None

        t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)  # noqa: E731
        frame_input = FrameInput(
            cam=cam,
            ego_quat=t(ego_quat),
            ego_rotmat=t(pose[:3, :3]),
            ego_trans=t(pose[:3, 3]),
            interp=interp,
        )
        name = os.path.basename(out.image_filenames[i]).split(".")[0]
        view = CameraView(
            frame_input=frame_input,
            image_path=out.image_filenames[i],
            H=H,
            W=W,
            cam=cam_sensor,
            frame=out.frames[i],
            frame_idx=out.frames_idx[i],
            timestamp=ts,
            is_val=is_val,
            image_name=name,
            sky_mask_path=os.path.join(sky_dir, f"{name}.png"),
            lidar_depth_path=os.path.join(depth_dir, f"{name}.npy"),
            obj_bound=out.obj_bounds[i],
            sky_scale=float(sky_scales[cam_sensor]) if cam_sensor < len(sky_scales) else 1.0,
        )
        (test_views if is_val else train_views).append(view)

    metadata = dict(
        num_images=len(out.exts),
        num_cams=len(cameras),
        num_frames=num_frames,
        camera_timestamps=camera_timestamps,
        scene_center=scene_center,
        scene_radius=scene_radius,
        sphere_center=sphere_center,
        sphere_radius=sphere_radius,
        obj_info=out.obj_info,
    )

    # persist the input point clouds
    if cfg.mode == "train" and out.points_xyz_dict:
        ply_dir = os.path.join(cfg.model_path, "input_ply")
        os.makedirs(ply_dir, exist_ok=True)
        for k in out.points_xyz_dict:
            name = "points3D_bkgd" if k == "bkgd" else f"points3D_{k}"
            if len(out.points_xyz_dict[k]):
                ply_utils.write_points_ply(
                    os.path.join(ply_dir, f"{name}.ply"),
                    out.points_xyz_dict[k],
                    out.points_rgb_dict[k],
                )

    return Scene(
        table=table,
        params_init=params,
        aux_init=aux,
        pose_data=pose_data,
        pose_params_init=pose_params,
        train_views=train_views,
        test_views=test_views,
        metadata=metadata,
    )
