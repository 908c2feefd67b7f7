# Port of the repo's root script/waymo/waymo_converter.py (lines 1-299), on the
# port's TFRecord reader (data/waymo_proto.py), image_io in place of cv2 and the
# range-image projection on a torch device.
"""Waymo Open Dataset tfrecord -> on-disk training sequence.

Port of the reference converter (ref: script/waymo/waymo_converter.py:
105-558 parse_seq_rawdata / process_list) on top of the TF-free
tfrecord/protobuf reader (street_gaussians_torch/data/waymo_proto.py).
Emits exactly the layout the Waymo loader consumes:

  images/{frame:06d}_{cam}.png      ego_pose/{frame:06d}[_{cam}].txt
  intrinsics/{cam}.txt              extrinsics/{cam}.txt
  pointcloud.npz                    track/track_info.txt
  track/track_camera_vis.json       dynamic_mask/{frame:06d}_{cam}.png
  timestamps.json

Usage:
  python -m street_gaussians_torch.script.waymo.waymo_converter --root_dir <tfrecord dir> \\
      --save_dir <out dir> [--segment_file <list.txt>] \\
      [--process_list pose calib image lidar track dynamic_mask] [--device cpu]

The text files are the root script's byte for byte; images and masks
its pixels (PNG through utils/image_io: frames stored as PNG are decoded
here, JPEG frames, as real segments carry them, through cv2, imported
then). The LiDAR range images are projected on the CUDA card unless
--device says otherwise (float64, see waymo_proto.project_to_pointcloud).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import time

import numpy as np

from street_gaussians_torch._device import resolve_device
from street_gaussians_torch.data import waymo_proto as wp
from street_gaussians_torch.utils.box import bbox_to_corner3d, get_bound_2d_mask
from street_gaussians_torch.utils.image_io import imdecode, imwrite

CAMERA_NAMES = {1: "FRONT", 2: "FRONT_LEFT", 3: "FRONT_RIGHT", 4: "SIDE_LEFT", 5: "SIDE_RIGHT"}
LASER_NAMES = {1: "TOP", 2: "FRONT", 3: "SIDE_LEFT", 4: "SIDE_RIGHT", 5: "REAR"}

# camera frame [forward, left, up] -> image frame [right, down, forward]
# (ref: waymo_converter.py:42-50)
OPENCV2CAMERA = np.array(
    [[0.0, 0.0, 1.0, 0.0], [-1.0, 0.0, 0.0, 0.0], [0.0, -1.0, 0.0, 0.0], [0.0, 0.0, 0.0, 1.0]]
)
PROCESS_LIST = ["pose", "calib", "image", "lidar", "track", "dynamic_mask"]


def get_extrinsic(calib: wp.CameraCalibration) -> np.ndarray:
    return calib.extrinsic @ OPENCV2CAMERA


def get_intrinsic(calib: wp.CameraCalibration) -> np.ndarray:
    fx, fy, cx, cy = calib.intrinsic[:4]
    return np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]])


def project_numpy(xyz, K, RT, H, W):
    """(ref: lib/utils/graphics_utils.py:102-146 project_numpy)"""
    pts_cam = xyz @ RT[:3, :3].T + RT[:3, 3]
    depth = pts_cam[:, 2]
    uvw = pts_cam @ K.T
    uv = uvw[:, :2] / np.clip(uvw[:, 2:], 1e-6, None)
    valid = (depth > 0) & (uv[:, 0] >= 0) & (uv[:, 0] < W) & (uv[:, 1] >= 0) & (uv[:, 1] < H)
    return uv, valid


def obj_pose_vehicle_from_box(box: wp.LabelBox) -> np.ndarray:
    c, s = math.cos(box.heading), math.sin(box.heading)
    pose = np.eye(4)
    pose[:3, :3] = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
    pose[:3, 3] = [box.center_x, box.center_y, box.center_z]
    return pose


def _box_corners_vehicle(dim, obj_pose):
    l, w, h = dim
    corners = bbox_to_corner3d(np.array([[-l, -w, -h], [l, w, h]]) * 0.5)
    corners = np.concatenate([corners, np.ones_like(corners[..., :1])], axis=-1)
    return (corners @ obj_pose.T)[..., :3]


def project_label_to_image(dim, obj_pose, calib):
    """(ref: waymo_converter.py:61-76)"""
    pts_vehicle = _box_corners_vehicle(dim, obj_pose)
    ext = get_extrinsic(calib)
    K = get_intrinsic(calib)
    return project_numpy(pts_vehicle, K, np.linalg.inv(ext), calib.height, calib.width)


def project_label_to_mask(dim, obj_pose, calib):
    """(ref: waymo_converter.py:78-94)"""
    pts_vehicle = _box_corners_vehicle(dim, obj_pose)
    ext = get_extrinsic(calib)
    K = get_intrinsic(calib)
    return get_bound_2d_mask(pts_vehicle, K, np.linalg.inv(ext), calib.height, calib.width)


def obj_class_of(label: wp.Label) -> str:
    return {
        wp.Label.TYPE_VEHICLE: "vehicle",
        wp.Label.TYPE_PEDESTRIAN: "pedestrian",
        wp.Label.TYPE_SIGN: "sign",
        wp.Label.TYPE_CYCLIST: "cyclist",
    }.get(label.type, "misc")


def parse_seq_rawdata(process_list, seq_path, seq_save_dir, cameras=(1, 2, 3, 4, 5), device=None) -> dict:
    """(ref: waymo_converter.py:99-524). Returns the seconds each stage
    took ("pose_calib_image", "lidar", "track", "dynamic_mask") and the
    frame and LiDAR point counts."""
    os.makedirs(seq_save_dir, exist_ok=True)
    stats = {"seconds": {}}

    if "pose" in process_list or "calib" in process_list or "image" in process_list:
        t0 = time.perf_counter()
        os.makedirs(os.path.join(seq_save_dir, "ego_pose"), exist_ok=True)
        os.makedirs(os.path.join(seq_save_dir, "intrinsics"), exist_ok=True)
        os.makedirs(os.path.join(seq_save_dir, "extrinsics"), exist_ok=True)
        os.makedirs(os.path.join(seq_save_dir, "images"), exist_ok=True)

        timestamps = {"FRAME": {}}
        for name in CAMERA_NAMES.values():
            timestamps[name] = {}

        calib_written = False
        num_frames = 0
        for frame_id, frame in enumerate(wp.WaymoTFRecordReader(seq_path)):
            num_frames += 1
            if not calib_written and "calib" in process_list:
                for calib in frame.camera_calibrations:
                    cam = calib.name - 1
                    fx, fy, cx, cy = calib.intrinsic[:4]
                    dist = list(calib.intrinsic[4:9]) + [0.0] * max(0, 5 - len(calib.intrinsic[4:9]))
                    np.savetxt(
                        os.path.join(seq_save_dir, "intrinsics", f"{cam}.txt"),
                        np.array([fx, fy, cx, cy] + dist[:5]),
                    )
                    np.savetxt(
                        os.path.join(seq_save_dir, "extrinsics", f"{cam}.txt"),
                        get_extrinsic(calib),
                    )
                calib_written = True

            if "pose" in process_list:
                np.savetxt(
                    os.path.join(seq_save_dir, "ego_pose", f"{frame_id:06d}.txt"),
                    frame.pose,
                )
            timestamps["FRAME"][f"{frame_id:06d}"] = frame.timestamp_micros / 1e6

            for image in frame.images:
                cam = image.name - 1
                if image.name not in cameras:
                    continue
                if "pose" in process_list:
                    np.savetxt(
                        os.path.join(seq_save_dir, "ego_pose", f"{frame_id:06d}_{cam}.txt"),
                        image.pose,
                    )
                timestamps[CAMERA_NAMES[image.name]][f"{frame_id:06d}"] = image.pose_timestamp
                if "image" in process_list and image.image:
                    path = os.path.join(seq_save_dir, "images", f"{frame_id:06d}_{cam}.png")
                    imwrite(path, imdecode(image.image, path))

        with open(os.path.join(seq_save_dir, "timestamps.json"), "w") as f:
            json.dump(timestamps, f)
        stats["frames"] = num_frames
        stats["seconds"]["pose_calib_image"] = time.perf_counter() - t0
        print("pose/calib/image done")

    if "lidar" in process_list:
        t0 = time.perf_counter()
        dev = resolve_device(device)
        pts3d_all, pts2d_all = {}, {}
        for frame_id, frame in enumerate(wp.WaymoTFRecordReader(seq_path)):
            pts3d, pts2d = [], []
            for laser in frame.lasers:
                if laser.ri_return1 is None:
                    continue
                ri = laser.ri_return1.range_image()
                if ri is None:
                    continue
                calib = wp.get_by_name(frame.laser_calibrations, laser.name)
                pcl, _ = wp.project_to_pointcloud(frame, ri, calib, device=dev)
                pts3d.append(pcl[:, :3].astype(np.float32))

                proj = laser.ri_return1.camera_projection()
                mask = ri[:, :, 0] > 0
                proj = proj[mask]
                # CameraName enums are 1-based; store 0-based like the
                # reference (waymo_converter.py:228-230)
                proj[:, 0] -= 1
                proj[:, 3] -= 1
                pts2d.append(proj.astype(np.int16))
            pts3d_all[frame_id] = np.concatenate(pts3d) if pts3d else np.zeros((0, 3), np.float32)
            pts2d_all[frame_id] = np.concatenate(pts2d) if pts2d else np.zeros((0, 6), np.int16)
        np.savez_compressed(
            os.path.join(seq_save_dir, "pointcloud.npz"),
            pointcloud=np.array(pts3d_all, dtype=object),
            camera_projection=np.array(pts2d_all, dtype=object),
        )
        stats["points_per_frame"] = [int(v.shape[0]) for v in pts3d_all.values()]
        stats["seconds"]["lidar"] = time.perf_counter() - t0
        print("lidar done")

    if "track" in process_list:
        t0 = time.perf_counter()
        track_dir = os.path.join(seq_save_dir, "track")
        os.makedirs(track_dir, exist_ok=True)
        lines = [
            "frame_id track_id object_class alpha box_height box_width box_length "
            "box_center_x box_center_y box_center_z box_heading speed"
        ]
        object_ids = {}
        bbox_visible = {}
        for frame_id, frame in enumerate(wp.WaymoTFRecordReader(seq_path)):
            for label in frame.laser_labels:
                box = label.box
                if box is None:
                    continue
                if label.id not in object_ids:
                    object_ids[label.id] = len(object_ids)
                tid = object_ids[label.id]
                obj_pose = obj_pose_vehicle_from_box(box)
                vis = []
                for calib in frame.camera_calibrations:
                    if calib.name not in cameras:
                        continue
                    _, valid = project_label_to_image(
                        [box.length, box.width, box.height], obj_pose, calib
                    )
                    if valid.any():
                        vis.append(calib.name - 1)
                bbox_visible.setdefault(str(tid), {})[str(frame_id)] = sorted(vis)
                speed = float(np.linalg.norm([label.speed_x, label.speed_y]))
                lines.append(
                    f"{frame_id} {tid} {obj_class_of(label)} -10 {box.height} {box.width} "
                    f"{box.length} {box.center_x} {box.center_y} {box.center_z} "
                    f"{box.heading} {speed} "
                )
        with open(os.path.join(track_dir, "track_info.txt"), "w") as f:
            f.write("\n".join(lines) + "\n")
        with open(os.path.join(track_dir, "track_camera_vis.json"), "w") as f:
            json.dump(bbox_visible, f)
        stats["seconds"]["track"] = time.perf_counter() - t0
        print("track done")

    if "dynamic_mask" in process_list:
        # speed > 1 m/s marks moving pixels (EmerNeRF convention,
        # ref: waymo_converter.py:476-484)
        t0 = time.perf_counter()
        mask_dir = os.path.join(seq_save_dir, "dynamic_mask")
        os.makedirs(mask_dir, exist_ok=True)
        for frame_id, frame in enumerate(wp.WaymoTFRecordReader(seq_path)):
            masks = {
                c.name: np.zeros((c.height, c.width), np.uint8)
                for c in frame.camera_calibrations
                if c.name in cameras
            }
            for label in frame.laser_labels:
                box = label.box
                if box is None:
                    continue
                if np.linalg.norm([label.speed_x, label.speed_y]) < 1.0:
                    continue
                obj_pose = obj_pose_vehicle_from_box(box)
                for calib in frame.camera_calibrations:
                    if calib.name not in masks:
                        continue
                    _, valid = project_label_to_image(
                        [box.length, box.width, box.height], obj_pose, calib
                    )
                    if valid.any():
                        m = project_label_to_mask(
                            [box.length, box.width, box.height], obj_pose, calib
                        )
                        masks[calib.name] = np.logical_or(masks[calib.name], m)
            for name, m in masks.items():
                imwrite(
                    os.path.join(mask_dir, f"{frame_id:06d}_{name - 1}.png"),
                    (m * 255).astype(np.uint8),
                )
        stats["seconds"]["dynamic_mask"] = time.perf_counter() - t0
        print("dynamic_mask done")
    return stats


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--process_list", type=str, nargs="+", default=list(PROCESS_LIST))
    parser.add_argument("--root_dir", type=str, required=True)
    parser.add_argument("--save_dir", type=str, required=True)
    parser.add_argument("--segment_file", type=str, default=None)
    parser.add_argument("--device", default=None, help="the LiDAR projection's device (default: the CUDA card)")
    args = parser.parse_args(argv)

    if args.segment_file and os.path.exists(args.segment_file):
        with open(args.segment_file) as f:
            segments = [l.strip() for l in f if l.strip()]
    else:
        segments = sorted(
            f for f in os.listdir(args.root_dir) if f.endswith(".tfrecord")
        )

    out = {}
    for i, seg in enumerate(segments):
        seq_path = os.path.join(args.root_dir, seg)
        seq_save_dir = os.path.join(args.save_dir, f"{i:03d}")
        print(f"Processing sequence {seg} -> {seq_save_dir}")
        out[seg] = parse_seq_rawdata(args.process_list, seq_path, seq_save_dir, device=args.device)
    return out


if __name__ == "__main__":
    main()
