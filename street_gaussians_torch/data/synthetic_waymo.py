# Copied from street_gaussians_tpu/data/synthetic_waymo.py, with PNGs written by
# utils/image_io.imwrite, two size keywords (image_size, points_per_frame) and
# actor_in_view.
"""Write a miniature Waymo-format sequence to disk for loader tests.

Emits exactly the on-disk layout the reference converter produces
(ref: script/waymo/waymo_converter.py:527: `images/`, `ego_pose/`,
`intrinsics/`, `extrinsics/`, `pointcloud.npz`, `track/`,
`timestamps.json`, `sky_mask/`, `lidar_depth/`) so
street_gaussians_torch/data/waymo.py can be exercised without real data.
"""

from __future__ import annotations

import json
import os

import numpy as np

from street_gaussians_torch.utils.image_io import imwrite


def write_synthetic_waymo(
    root: str,
    num_frames: int = 4,
    cameras=(0, 1, 2),
    seed: int = 0,
    with_sky_mask: bool = True,
    with_lidar_depth: bool = True,
    image_size=(64, 96),
    points_per_frame: int = 600,
    actor_in_view: bool = False,
):
    """Write the sequence under root. image_size (H, W) sets every sensor's
    image size (the default stands in for Waymo's 1280x1920) with focal
    length 80 * W / 96, so the geometry does not depend on it;
    points_per_frame is the LiDAR sweep size. The cameras look along the
    ego's -y axis, past the moving vehicle (track 7); actor_in_view puts
    it 5.5 m in front of camera 0 instead, drifting 0.2 m a frame along
    the ego's x, so that every camera sees it. The defaults write the JAX
    package's sequence."""
    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    for sub in ("images", "ego_pose", "intrinsics", "extrinsics", "track",
                "sky_mask", "lidar_depth"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)

    H, W = image_size
    # intrinsics / extrinsics for all 5 sensors
    for c in range(5):
        fx = fy = 80.0 * W / 96
        np.savetxt(
            os.path.join(root, "intrinsics", f"{c}.txt"),
            np.array([fx, fy, W / 2, H / 2, 0, 0, 0, 0, 0]),
        )
        ext = np.eye(4)
        # camera-to-ego: camera looks along ego +x; camera frame z-forward
        ext[:3, :3] = np.array([[0, 0, 1], [-1, 0, 0], [0, -1, 0]]).T
        ext[:3, 3] = [1.5, (c - 1) * 0.5, 2.0]
        np.savetxt(os.path.join(root, "extrinsics", f"{c}.txt"), ext)

    timestamps = {"FRAME": {}}
    for name in ("FRONT", "FRONT_LEFT", "FRONT_RIGHT", "SIDE_LEFT", "SIDE_RIGHT"):
        timestamps[name] = {}

    pts3d, pts2d = {}, {}
    track_lines = ["frame_id track_id object_class alpha box_height box_width box_length box_center_x box_center_y box_center_z box_heading speed"]
    camera_vis = {"7": {}, "8": {}}

    for f in range(num_frames):
        # ego drives along +x
        ego = np.eye(4)
        ego[:3, 3] = [f * 2.0, 0.0, 0.0]
        np.savetxt(os.path.join(root, "ego_pose", f"{f:06d}.txt"), ego)
        t_frame = 100.0 + f * 0.1
        timestamps["FRAME"][f"{f:06d}"] = t_frame
        for c in range(5):
            np.savetxt(os.path.join(root, "ego_pose", f"{f:06d}_{c}.txt"), ego)
            name = ("FRONT", "FRONT_LEFT", "FRONT_RIGHT", "SIDE_LEFT", "SIDE_RIGHT")[c]
            timestamps[name][f"{f:06d}"] = t_frame + 0.01 * c
            img = (rng.uniform(0, 255, (H, W, 3))).astype(np.uint8)
            imwrite(os.path.join(root, "images", f"{f:06d}_{c}.png"), img)
            if with_sky_mask:
                sky = np.zeros((H, W), np.uint8)
                sky[: H // 4] = 255
                imwrite(os.path.join(root, "sky_mask", f"{f:06d}_{c}.png"), sky)
            if with_lidar_depth:
                mask = np.zeros((H, W), bool)
                mask[H // 2 :, :] = rng.uniform(size=(H - H // 2, W)) < 0.1
                value = rng.uniform(2, 30, mask.sum()).astype(np.float32)
                np.save(
                    os.path.join(root, "lidar_depth", f"{f:06d}_{c}.npy"),
                    {"mask": mask, "value": value},
                    allow_pickle=True,
                )

        # lidar: points in vehicle frame + camera projections
        n = points_per_frame
        pts = np.stack(
            [
                rng.uniform(3, 30, n),
                rng.uniform(-10, 10, n),
                rng.uniform(-1.5, 3, n),
            ],
            axis=-1,
        ).astype(np.float32)
        # camera_projection rows: (cam1, x1, y1, cam2, x2, y2) int16, second
        # projection UNKNOWN (-1) — the converter's layout
        # (ref: waymo_converter.py:218-232)
        proj = np.stack(
            [
                rng.choice(list(cameras), n),
                rng.integers(0, W, n),
                rng.integers(0, H, n),
                np.full(n, -1),
                np.zeros(n),
                np.zeros(n),
            ],
            axis=-1,
        ).astype(np.int16)
        pts3d[f] = pts
        pts2d[f] = proj

        # two tracked objects: one moving (7), one static (8, gets removed)
        if actor_in_view:
            track_lines.append(f"{f} 7 vehicle 0.0 1.6 2.0 4.5 {1.5 + 0.2 * (f - num_frames / 2)} -6.0 0.8 0.1 5.0")
        else:
            x_mov = 10.0 + 1.5 * f
            track_lines.append(
                f"{f} 7 vehicle 0.0 1.6 2.0 4.5 {x_mov - f * 2.0} -2.0 0.5 0.1 5.0"
            )
        track_lines.append(f"{f} 8 vehicle 0.0 1.5 1.9 4.2 {8.0 - f * 2.0} 3.0 0.5 0.0 0.0")
        camera_vis["7"][str(f)] = list(cameras)
        camera_vis["8"][str(f)] = list(cameras)

    np.savez(
        os.path.join(root, "pointcloud.npz"),
        pointcloud=np.array(pts3d, dtype=object),
        camera_projection=np.array(pts2d, dtype=object),
    )
    with open(os.path.join(root, "timestamps.json"), "w") as fjson:
        json.dump(timestamps, fjson)
    with open(os.path.join(root, "track", "track_info.txt"), "w") as ftrack:
        ftrack.write("\n".join(track_lines) + "\n")
    with open(os.path.join(root, "track", "track_camera_vis.json"), "w") as fvis:
        json.dump(camera_vis, fvis)
    return dict(H=H, W=W, num_frames=num_frames)
