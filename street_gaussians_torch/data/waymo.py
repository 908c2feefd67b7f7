# Copied from street_gaussians_tpu/data/waymo.py.
"""Waymo processed-sequence loader.

Reads the same on-disk format the reference's converter emits
(ref: script/waymo/waymo_converter.py:527 process_list → `images/`,
`ego_pose/`, `intrinsics/`, `extrinsics/`, `pointcloud.npz`, `track/`,
`timestamps.json`, plus optional `sky_mask/`, `lidar_depth/`) and
reproduces the dataparser pipeline of lib/utils/waymo_utils.py:41-710 +
lib/datasets/waymo_full_readers.py:16-226:

  * camera calibration + per-frame/per-image ego poses re-centered at
    the mean ego position,
  * tracklet parsing with static-object removal and column clipping,
  * initial point clouds: LiDAR colored by camera projection, box-carved
    per-actor clouds in canonical frames, voxel-downsampled +
    outlier-filtered background merged with a distance-filtered COLMAP
    SfM cloud when present (no COLMAP subprocess is launched here —
    an existing triangulated model is read, otherwise skipped),
  * projected-box `obj_bound` guidance masks, sky masks, sparse LiDAR
    depth maps.

All host-side numpy; the Scene assembly into device arrays lives in
street_gaussians_torch/data/dataset.py.
"""

from __future__ import annotations

import dataclasses
import json
import os
from glob import glob
from typing import Dict, List, Optional

import numpy as np

from street_gaussians_torch.data import colmap_model
from street_gaussians_torch.utils.box import bbox_to_corner3d, get_bound_2d_mask, inbbox_points
from street_gaussians_torch.utils.image_io import imread
from street_gaussians_torch.utils.pointcloud import (
    remove_radius_outliers,
    sphere_norm,
    voxel_downsample,
)

WAYMO_TRACK2LABEL = {"vehicle": 0, "pedestrian": 1, "cyclist": 2, "sign": 3, "misc": -1}
LABEL2CAMERA = {0: "FRONT", 1: "FRONT_LEFT", 2: "FRONT_RIGHT", 3: "SIDE_LEFT", 4: "SIDE_RIGHT"}
# Waymo native sensor resolutions (ref: waymo_utils.py:35-36). Used only
# as a fallback — sensor_image_sizes() reads the actual size off the
# first image of each sensor, so non-Waymo-resolution sequences load too.
IMAGE_HEIGHTS = [1280, 1280, 1280, 886, 886]
IMAGE_WIDTHS = [1920, 1920, 1920, 1920, 1920]


def num_sensors(datadir: str) -> int:
    """Number of camera sensors in a processed sequence, from the count
    of `intrinsics/<i>.txt` files (5 for Waymo, 2 for converted KITTI)."""
    return len(
        [f for f in os.listdir(os.path.join(datadir, "intrinsics")) if f.endswith(".txt")]
    )


def sensor_image_sizes(image_filenames, cams) -> Dict[int, tuple]:
    """{sensor: (H, W)} from the first on-disk image per sensor."""
    sizes: Dict[int, tuple] = {}
    for fn, cam in zip(image_filenames, cams):
        if cam not in sizes:
            img = imread(fn)
            if img is not None:
                sizes[cam] = img.shape[:2]
    for cam in set(cams) - set(sizes):
        sizes[cam] = (IMAGE_HEIGHTS[cam], IMAGE_WIDTHS[cam])
    return sizes


def image_filename_to_cam(x: str) -> int:
    return int(x.split(".")[0][-1])


def image_filename_to_frame(x: str) -> int:
    return int(x.split(".")[0][:6])


def rotmat_to_quat_np(m: np.ndarray) -> np.ndarray:
    """3x3 -> (w, x, y, z), numpy (host-side analog of
    lib/utils/general_utils.py:103-145)."""
    tr = m[0, 0] + m[1, 1] + m[2, 2]
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        q = [0.25 * s, (m[2, 1] - m[1, 2]) / s, (m[0, 2] - m[2, 0]) / s, (m[1, 0] - m[0, 1]) / s]
    elif m[0, 0] > m[1, 1] and m[0, 0] > m[2, 2]:
        s = np.sqrt(1.0 + m[0, 0] - m[1, 1] - m[2, 2]) * 2
        q = [(m[2, 1] - m[1, 2]) / s, 0.25 * s, (m[0, 1] + m[1, 0]) / s, (m[0, 2] + m[2, 0]) / s]
    elif m[1, 1] > m[2, 2]:
        s = np.sqrt(1.0 - m[0, 0] + m[1, 1] - m[2, 2]) * 2
        q = [(m[0, 2] - m[2, 0]) / s, (m[0, 1] + m[1, 0]) / s, 0.25 * s, (m[1, 2] + m[2, 1]) / s]
    else:
        s = np.sqrt(1.0 - m[0, 0] - m[1, 1] + m[2, 2]) * 2
        q = [(m[1, 0] - m[0, 1]) / s, (m[0, 2] + m[2, 0]) / s, (m[1, 2] + m[2, 1]) / s, 0.25 * s]
    q = np.array(q, np.float64)
    return (q / np.linalg.norm(q)).astype(np.float32)


def get_val_frames(num_frames: int, test_every: Optional[int], train_every: Optional[int]):
    """Train/test frame-index split (ref: lib/utils/data_utils.py:36-47).

    One of test_every / train_every is set; when both are None every
    frame trains (the reference never hits that case because configs
    always set split_train or split_test)."""
    if train_every is None or train_every < 0:
        if test_every is None:
            return sorted(np.arange(num_frames)), []
        val_frames = set(np.arange(test_every, num_frames, test_every))
        train_frames = (
            set(np.arange(num_frames)) - val_frames if test_every > 1 else set()
        )
    else:
        train_frames = set(np.arange(0, num_frames, train_every))
        val_frames = (
            set(np.arange(num_frames)) - train_frames if train_every > 1 else set()
        )
    return sorted(train_frames), sorted(val_frames)


def load_camera_info(datadir: str):
    """(ref: waymo_utils.py:41-80)"""
    n_cams = num_sensors(datadir)
    intrinsics, extrinsics = [], []
    for i in range(n_cams):
        intr = np.loadtxt(os.path.join(datadir, "intrinsics", f"{i}.txt"))
        fx, fy, cx, cy = intr[0], intr[1], intr[2], intr[3]
        intrinsics.append(np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]]))
        extrinsics.append(np.loadtxt(os.path.join(datadir, "extrinsics", f"{i}.txt")))

    ego_pose_dir = os.path.join(datadir, "ego_pose")
    ego_frame_poses = []
    ego_cam_poses = [[] for _ in range(n_cams)]
    for name in sorted(os.listdir(ego_pose_dir)):
        pose = np.loadtxt(os.path.join(ego_pose_dir, name))
        if "_" not in name:
            ego_frame_poses.append(pose)
        else:
            ego_cam_poses[image_filename_to_cam(name)].append(pose)

    ego_frame_poses = np.array(ego_frame_poses)
    center_point = np.mean(ego_frame_poses[:, :3, 3], axis=0)
    ego_frame_poses[:, :3, 3] -= center_point
    ego_cam_poses = np.array([np.array(p) for p in ego_cam_poses])
    if ego_cam_poses.size:
        ego_cam_poses[:, :, :3, 3] -= center_point
    return intrinsics, extrinsics, ego_frame_poses, ego_cam_poses


def make_obj_pose(ego_pose: np.ndarray, box_info):
    """(ref: waymo_utils.py:84-110): box (x, y, z, heading) -> 7-vector
    (pos, quat) in vehicle and world frames."""
    tx, ty, tz, heading = box_info
    c, s = np.cos(heading), np.sin(heading)
    rotz = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
    obj_pose_vehicle = np.eye(4)
    obj_pose_vehicle[:3, :3] = rotz
    obj_pose_vehicle[:3, 3] = [tx, ty, tz]
    obj_pose_world = ego_pose @ obj_pose_vehicle

    vehicle7 = np.concatenate(
        [obj_pose_vehicle[:3, 3], rotmat_to_quat_np(obj_pose_vehicle[:3, :3])]
    )
    world7 = np.concatenate(
        [obj_pose_world[:3, 3], rotmat_to_quat_np(obj_pose_world[:3, :3])]
    )
    return vehicle7, world7


def get_obj_pose_tracking(
    datadir: str,
    selected_frames,
    ego_poses: np.ndarray,
    cameras=(0, 1, 2),
    box_scale: float = 1.0,
    use_tracker: bool = False,
):
    """(ref: waymo_utils.py:112-288)"""
    suffix = "_castrack" if use_tracker else ""
    tracklet_path = os.path.join(datadir, f"track/track_info{suffix}.txt")
    vis_path = os.path.join(datadir, f"track/track_camera_vis{suffix}.json")

    with open(tracklet_path) as f:
        tracklets_str = f.read().splitlines()[1:]
    with open(vis_path) as f:
        camera_vis = json.load(f)

    start_frame, end_frame = selected_frames
    num_frames = end_frame - start_frame + 1

    objects_info: Dict[int, dict] = {}
    rows = []
    image_dir = os.path.join(datadir, "images")
    n_frames_all = len(os.listdir(image_dir)) // num_sensors(datadir)
    n_obj_in_frame = np.zeros(n_frames_all)

    for line in tracklets_str:
        t = line.split()
        frame_id, track_id, obj_class = int(t[0]), int(t[1]), t[2]
        if obj_class in ("sign", "misc"):
            continue
        vis = camera_vis[str(track_id)][str(frame_id)]
        if not set(cameras) & set(vis):
            continue
        info = objects_info.setdefault(
            track_id,
            dict(
                track_id=track_id,
                **{"class": obj_class},
                class_label=WAYMO_TRACK2LABEL[obj_class],
                height=float(t[4]),
                width=float(t[5]),
                length=float(t[6]),
            ),
        )
        info["height"] = max(info["height"], float(t[4]))
        info["width"] = max(info["width"], float(t[5]))
        info["length"] = max(info["length"], float(t[6]))
        rows.append((frame_id, track_id, [float(x) for x in t[7:11]]))
        n_obj_in_frame[frame_id] += 1

    max_obj = int(n_obj_in_frame[start_frame : end_frame + 1].max()) if rows else 1
    ids = np.full((num_frames, max_obj), -1.0)
    pose_vehicle = np.full((num_frames, max_obj, 7), -1.0)
    pose_world = np.full((num_frames, max_obj, 7), -1.0)

    for frame_id, track_id, box in rows:
        if start_frame <= frame_id <= end_frame:
            f = frame_id - start_frame
            col = int(np.argwhere(ids[f] < 0).min())
            v7, w7 = make_obj_pose(ego_poses[frame_id], box)
            ids[f, col] = track_id
            pose_vehicle[f, col] = v7
            pose_world[f, col] = w7

    # remove static objects (std > 0.5 on any axis OR first-last
    # displacement > 2 m keeps an object; waymo_utils.py:194-208)
    for key in list(objects_info.keys()):
        idx = np.where(ids == key)
        if len(idx[0]) == 0:
            objects_info.pop(key)
            continue
        pos = pose_world[idx][:, :3]
        displacement = np.linalg.norm(pos[0] - pos[-1])
        dynamic = np.any(np.std(pos, axis=0) > 0.5) or displacement > 2
        if not dynamic:
            ids[idx] = -1.0
            pose_vehicle[idx] = -1.0
            pose_world[idx] = -1.0
            objects_info.pop(key)

    # clip columns (waymo_utils.py:210-235)
    max_new = int((ids >= 0).sum(axis=1).max()) if (ids >= 0).any() else 0
    if max_new == 0:
        ids = np.full((num_frames, 1), -1.0)
        pose_vehicle = np.full((num_frames, 1, 7), -1.0)
        pose_world = np.full((num_frames, 1, 7), -1.0)
    elif max_new < max_obj:
        ids_n = np.full((num_frames, max_new), -1.0)
        pv_n = np.full((num_frames, max_new, 7), -1.0)
        pw_n = np.full((num_frames, max_new, 7), -1.0)
        for f in range(num_frames):
            col = 0
            for y in range(max_obj):
                if ids[f, y] >= 0:
                    ids_n[f, col] = ids[f, y]
                    pv_n[f, col] = pose_vehicle[f, y]
                    pw_n[f, col] = pose_world[f, y]
                    col += 1
        ids, pose_vehicle, pose_world = ids_n, pv_n, pw_n

    frames_arr = np.arange(start_frame, end_frame + 1, dtype=np.int32)
    for key, obj in objects_info.items():
        obj["deformable"] = obj["class"] == "pedestrian"
        obj["width"] *= box_scale
        obj["length"] *= box_scale
        fidx = np.argwhere(ids == key)[:, 0].astype(np.int32)
        obj["start_frame"] = int(frames_arr[fidx].min())
        obj["end_frame"] = int(frames_arr[fidx].max())

    tracklets_world = np.concatenate([ids[..., None], pose_world], axis=-1)
    tracklets_vehicle = np.concatenate([ids[..., None], pose_vehicle], axis=-1)
    return tracklets_world, tracklets_vehicle, objects_info


@dataclasses.dataclass
class WaymoParserOutput:
    num_frames: int
    exts: np.ndarray
    ixts: np.ndarray
    poses: np.ndarray
    c2ws: np.ndarray
    obj_tracklets: np.ndarray  # vehicle-frame [F, O, 8]
    obj_info: Dict[int, dict]
    frames: List[int]
    cams: List[int]
    frames_idx: List[int]
    image_filenames: List[str]
    cams_timestamps: np.ndarray
    tracklet_timestamps: np.ndarray
    obj_bounds: List[np.ndarray]
    sensor_sizes: Dict[int, tuple]
    points_xyz_dict: Dict[str, np.ndarray]
    points_rgb_dict: Dict[str, np.ndarray]
    sphere_center: Optional[np.ndarray]
    sphere_radius: Optional[float]


def generate_dataparser_outputs(
    datadir: str,
    selected_frames=None,
    cameras=(0, 1, 2),
    build_pointcloud: bool = True,
    box_scale: float = 1.0,
    use_tracker: bool = False,
    colmap_model_dir: Optional[str] = None,
    filter_colmap: bool = False,
    extent_for_colmap_filter: float = 10.0,
    sphere_scale: float = 1.0,
    initial_num_obj: int = 20000,
) -> WaymoParserOutput:
    """(ref: waymo_utils.py:291-710)"""
    image_dir = os.path.join(datadir, "images")
    image_filenames_all = sorted(glob(os.path.join(image_dir, "*.png"))) or sorted(
        glob(os.path.join(image_dir, "*.jpg"))
    )
    num_frames_all = len(image_filenames_all) // num_sensors(datadir)
    num_cameras = len(cameras)

    if selected_frames is None:
        start_frame, end_frame = 0, num_frames_all - 1
    else:
        start_frame, end_frame = selected_frames
    num_frames = end_frame - start_frame + 1

    intrinsics, extrinsics, ego_frame_poses, ego_cam_poses = load_camera_info(datadir)

    frames, frames_idx, cams, image_filenames = [], [], [], []
    ixts, exts, poses, c2ws, cams_timestamps = [], [], [], [], []

    with open(os.path.join(datadir, "timestamps.json")) as f:
        timestamps = json.load(f)
    frames_timestamps = [
        timestamps["FRAME"][f"{frame:06d}"] for frame in range(start_frame, end_frame + 1)
    ]

    for fn in image_filenames_all:
        base = os.path.basename(fn)
        frame, cam = image_filename_to_frame(base), image_filename_to_cam(base)
        if start_frame <= frame <= end_frame and cam in cameras:
            ext = extrinsics[cam]
            pose = ego_cam_poses[cam, frame]
            frames.append(frame)
            frames_idx.append(frame - start_frame)
            cams.append(cam)
            image_filenames.append(fn)
            ixts.append(intrinsics[cam])
            exts.append(ext)
            poses.append(pose)
            c2ws.append(pose @ ext)
            cams_timestamps.append(timestamps[LABEL2CAMERA[cam]][f"{frame:06d}"])

    exts = np.stack(exts)
    ixts = np.stack(ixts)
    poses = np.stack(poses)
    c2ws = np.stack(c2ws)

    offset = min(list(cams_timestamps) + list(frames_timestamps))
    cams_timestamps = np.array(cams_timestamps) - offset
    frames_timestamps = np.array(frames_timestamps) - offset

    tracklets_world, tracklets_vehicle, obj_info = get_obj_pose_tracking(
        datadir, (start_frame, end_frame), ego_frame_poses, cameras, box_scale, use_tracker
    )

    # projected-box obj_bound masks (waymo_utils.py:407-437)
    sizes = sensor_image_sizes(image_filenames, cams)
    obj_bounds = []
    for i in range(len(image_filenames)):
        cam = cams[i]
        h, w = sizes[cam]
        bound = np.zeros((h, w), np.uint8)
        for tr in tracklets_vehicle[frames_idx[i]]:
            tid = int(tr[0])
            if tid < 0:
                continue
            opv = np.eye(4)
            opv[:3, :3] = _quat_to_rotmat_np(tr[4:8])
            opv[:3, 3] = tr[1:4]
            o = obj_info[tid]
            bbox = np.array(
                [[-o["length"], -o["width"], -o["height"]], [o["length"], o["width"], o["height"]]]
            ) * 0.5
            corners = bbox_to_corner3d(bbox)
            corners = np.concatenate([corners, np.ones_like(corners[..., :1])], axis=-1)
            corners_vehicle = corners @ opv.T
            mask = get_bound_2d_mask(
                corners_vehicle[..., :3], ixts[i], np.linalg.inv(exts[i]), h, w
            )
            bound = np.logical_or(bound, mask)
        obj_bounds.append(bound)

    points_xyz_dict: Dict[str, np.ndarray] = {}
    points_rgb_dict: Dict[str, np.ndarray] = {}
    sphere_center, sphere_radius = None, None

    if build_pointcloud:
        points_xyz_dict, points_rgb_dict, sphere_center, sphere_radius = _build_pointclouds(
            datadir,
            cameras,
            start_frame,
            end_frame,
            num_cameras,
            cams,
            image_filenames,
            ego_frame_poses,
            tracklets_vehicle,
            obj_info,
            c2ws,
            colmap_model_dir,
            filter_colmap,
            extent_for_colmap_filter,
            sphere_scale,
            initial_num_obj,
        )

    return WaymoParserOutput(
        num_frames=num_frames,
        exts=exts,
        ixts=ixts,
        poses=poses,
        c2ws=c2ws,
        obj_tracklets=tracklets_vehicle,
        obj_info=obj_info,
        frames=frames,
        cams=cams,
        frames_idx=frames_idx,
        image_filenames=image_filenames,
        cams_timestamps=cams_timestamps,
        tracklet_timestamps=frames_timestamps,
        obj_bounds=obj_bounds,
        sensor_sizes=sizes,
        points_xyz_dict=points_xyz_dict,
        points_rgb_dict=points_rgb_dict,
        sphere_center=sphere_center,
        sphere_radius=sphere_radius,
    )


def _quat_to_rotmat_np(q):
    w, x, y, z = q
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


def _build_pointclouds(
    datadir,
    cameras,
    start_frame,
    end_frame,
    num_cameras,
    cams,
    image_filenames,
    ego_frame_poses,
    tracklets_vehicle,
    obj_info,
    c2ws,
    colmap_model_dir,
    filter_colmap,
    extent,
    sphere_scale,
    initial_num_obj,
):
    """(ref: waymo_utils.py:450-710)"""
    data = np.load(os.path.join(datadir, "pointcloud.npz"), allow_pickle=True)
    pts3d_dict = data["pointcloud"].item()
    pts2d_dict = data["camera_projection"].item()

    xyz_acc: Dict[str, list] = {"bkgd": []}
    rgb_acc: Dict[str, list] = {"bkgd": []}
    for tid in obj_info:
        xyz_acc[f"obj_{tid:03d}"] = []
        rgb_acc[f"obj_{tid:03d}"] = []

    for i, frame in enumerate(range(start_frame, end_frame + 1)):
        idxs = list(range(i * num_cameras, (i + 1) * num_cameras))
        cams_frame = [cams[idx] for idx in idxs]
        files_frame = [image_filenames[idx] for idx in idxs]

        raw_3d = pts3d_dict[frame]
        raw_2d = pts2d_dict[frame]
        cam_col = raw_2d[..., 0]
        projw = raw_2d[..., 1]
        projh = raw_2d[..., 2]
        mask = np.isin(cam_col, list(cameras))

        pts_vehicle = raw_3d[mask]
        pts_vehicle_h = np.concatenate(
            [pts_vehicle, np.ones_like(pts_vehicle[..., :1])], axis=-1
        )
        pts_world = pts_vehicle_h @ ego_frame_poses[frame].T

        rgb = np.ones_like(pts_vehicle)
        p_cam, p_w, p_h = cam_col[mask], projw[mask], projh[mask]
        for cam, fn in zip(cams_frame, files_frame):
            m = p_cam == cam
            img = imread(fn)[..., [2, 1, 0]] / 255.0
            rgb[m] = img[p_h[m].astype(int), p_w[m].astype(int)]

        in_obj = np.zeros(pts_vehicle.shape[0], bool)
        for tr in tracklets_vehicle[i]:
            tid = int(tr[0])
            if tid < 0:
                continue
            opv = np.eye(4)
            opv[:3, :3] = _quat_to_rotmat_np(tr[4:8])
            opv[:3, 3] = tr[1:4]
            pts_obj = pts_vehicle_h @ np.linalg.inv(opv).T
            o = obj_info[tid]
            corners = bbox_to_corner3d(
                [[-o["length"] / 2, -o["width"] / 2, -o["height"] / 2],
                 [o["length"] / 2, o["width"] / 2, o["height"] / 2]]
            )
            inb = inbbox_points(pts_obj[..., :3], corners)
            in_obj |= inb
            xyz_acc[f"obj_{tid:03d}"].append(pts_obj[inb][..., :3])
            rgb_acc[f"obj_{tid:03d}"].append(rgb[inb])

        xyz_acc["bkgd"].append(pts_world[~in_obj][..., :3])
        rgb_acc["bkgd"].append(rgb[~in_obj])

    points_xyz: Dict[str, np.ndarray] = {}
    points_rgb: Dict[str, np.ndarray] = {}
    for k, v in xyz_acc.items():
        if not v:
            continue
        xyz = np.concatenate(v).astype(np.float32)
        rgb = np.concatenate(rgb_acc[k]).astype(np.float32)
        if k == "bkgd":
            # 0.15 m voxel downsample + radius outlier removal
            # (waymo_utils.py:553-561)
            xyz, rgb = voxel_downsample(xyz, rgb, 0.15)
            xyz_f, rgb_f = remove_radius_outliers(xyz, rgb, nb_points=10, radius=0.5)
            if len(xyz_f):  # keep the unfiltered cloud if the filter wipes it
                xyz, rgb = xyz_f, rgb_f
        elif len(xyz) > initial_num_obj:
            sel = np.random.choice(len(xyz), initial_num_obj, replace=False)
            xyz, rgb = xyz[sel], rgb[sel]
        points_xyz[k] = xyz
        points_rgb[k] = rgb

    lidar_xyz = points_xyz["bkgd"]
    lidar_rgb = points_rgb["bkgd"]
    sphere_center, sphere_radius = sphere_norm(lidar_xyz, sphere_scale)

    # merge distance-filtered COLMAP SfM points (waymo_utils.py:586-610)
    colmap_xyz = np.zeros((0, 3), np.float32)
    colmap_rgb = np.zeros((0, 3), np.float32)
    if colmap_model_dir and os.path.exists(colmap_model_dir):
        colmap_xyz, colmap_rgb, _ = colmap_model.read_points3d(colmap_model_dir)
        if filter_colmap:
            keep = np.ones(colmap_xyz.shape[0], bool)
            for c2w in c2ws:
                cam_pos = c2w[:3, 3]
                radius = np.linalg.norm(colmap_xyz - cam_pos, axis=-1)
                bad = np.logical_or(radius < extent, colmap_xyz[:, 2] < cam_pos[2])
                keep &= ~bad
            colmap_xyz, colmap_rgb = colmap_xyz[keep], colmap_rgb[keep]
        dist = np.linalg.norm(colmap_xyz - sphere_center[None], axis=-1)
        m = dist < 2 * sphere_radius
        colmap_xyz, colmap_rgb = colmap_xyz[m], colmap_rgb[m]

    points_xyz["lidar"] = lidar_xyz
    points_rgb["lidar"] = lidar_rgb
    points_xyz["colmap"] = colmap_xyz
    points_rgb["colmap"] = colmap_rgb
    points_xyz["bkgd"] = np.concatenate([lidar_xyz, colmap_xyz]).astype(np.float32)
    points_rgb["bkgd"] = np.concatenate([lidar_rgb, colmap_rgb]).astype(np.float32)
    return points_xyz, points_rgb, sphere_center, sphere_radius


def load_lidar_depth(path: str) -> np.ndarray:
    """Sparse depth {mask, value} npy -> dense HxW with zeros
    (ref: waymo_full_readers.py:134-142)."""
    depth = np.load(path, allow_pickle=True)
    depth = dict(depth.item())
    out = np.zeros_like(depth["mask"], np.float32)
    out[depth["mask"]] = depth["value"]
    return out


def load_sky_mask(path: str) -> np.ndarray:
    """(ref: waymo_full_readers.py:144-148)"""
    return imread(path)[..., 0] > 0.0
