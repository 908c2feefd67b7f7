# Port of the repo's root script/kitti/kitti_converter.py (lines 1-386): image
# sizes from the PNG header (utils/image_io.image_size) in place of cv2.imread;
# every output file byte for byte the root script's.
"""KITTI tracking sequence -> the on-disk scene format of the Waymo loader.

The reference ships a KITTI pipeline that is broken in its snapshot
(`script/kitti/colmap_kitti.py:12` imports `lib.utils.kitti_utils`,
which does not exist). Rather than reproduce a dead code path, this
converter makes KITTI a *working* dataset family: it reads the raw
KITTI tracking layout (`image_02/03`, `calib`, `oxts`, `label_02`,
`velodyne`) and emits exactly the on-disk layout the Waymo pipeline
consumes (`images/`, `ego_pose/`, `intrinsics/`, `extrinsics/`,
`pointcloud.npz`, `track/`, `timestamps.json` — the format of
`script/waymo/waymo_converter.py`, ref: waymo_converter.py:527), so the
entire existing training/rendering stack works unchanged with
`data.type: Kitti`.

Frame conventions (KITTI devkit):
  - oxts (lat, lon, alt, roll, pitch, yaw) -> IMU pose via the mercator
    projection; the IMU frame (x forward, y left, z up) becomes the ego
    frame, matching the Waymo vehicle frame.
  - calib `P2/P3` are rectified projections K [I | t]; `R_rect` is the
    cam0 rectifying rotation, `Tr_velo_cam` velodyne->cam0,
    `Tr_imu_velo` imu->velodyne.
  - label_02 boxes are in RECTIFIED cam0 coordinates with the location
    at the bottom-face center and `rotation_y` about the camera y axis;
    they are converted to ego-frame center + z-yaw.

Camera index mapping: image_02 (left color) -> 0, image_03 (right
color) -> 1.

Usage:
  python -m street_gaussians_torch.script.kitti.kitti_converter \
      --kitti_dir /data/kitti/tracking/training --seq 0002 \
      --out_dir data/kitti/0002 [--start 0 --end 100]

Host numpy: KITTI's ~120,000 velodyne points a frame are projected on the
host, so that pointcloud.npz stays the root script's array for array.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
from glob import glob

import numpy as np

from street_gaussians_torch.utils.image_io import image_size

EARTH_RADIUS = 6378137.0
KITTI_FPS = 10.0
# KITTI type -> the reference's Waymo class vocabulary
# (ref: lib/utils/waymo_utils.py tracklet classes; 'sign'/'misc' are
# skipped by the tracklet reader)
KITTI_CLASS_MAP = {
    "Car": "vehicle",
    "Van": "vehicle",
    "Truck": "vehicle",
    "Tram": "vehicle",
    "Pedestrian": "pedestrian",
    "Person": "pedestrian",
    "Person_sitting": "pedestrian",
    "Cyclist": "cyclist",
    "Misc": "misc",
    "DontCare": "misc",
}
CAM_DIRS = {0: "image_02", 1: "image_03"}
CAM_NAMES = {0: "FRONT", 1: "FRONT_LEFT"}  # timestamps.json keys (data/waymo.py:45)


def read_calib(path: str):
    """Parse a KITTI tracking calib file into a dict of arrays."""
    out = {}
    with open(path) as f:
        for line in f:
            if ":" in line:
                key, vals = line.split(":", 1)
            else:
                parts = line.split()
                if not parts:
                    continue
                key, vals = parts[0], " ".join(parts[1:])
            key = key.strip()
            arr = np.array([float(x) for x in vals.split()])
            out[key] = arr
    calib = {}
    for i in (2, 3):
        P = out[f"P{i}"].reshape(3, 4)
        calib[f"P{i}"] = P
    rect = out.get("R_rect", out.get("R0_rect"))
    if rect is None:
        raise ValueError(
            f"{path}: no rectification matrix found — expected a KITTI "
            f"tracking calib with key 'R_rect' (or 'R0_rect'); raw-data "
            f"per-camera keys like 'R_rect_00' are not supported, run the "
            f"devkit's tracking export first (keys present: {sorted(out)})"
        )
    calib["R_rect"] = rect.reshape(3, 3)
    for src, dst in (("Tr_velo_cam", "Tr_velo_cam"), ("Tr_velo_to_cam", "Tr_velo_cam"),
                     ("Tr_imu_velo", "Tr_imu_velo"), ("Tr_imu_to_velo", "Tr_imu_velo")):
        if src in out:
            T = np.eye(4)
            T[:3] = out[src].reshape(3, 4)
            calib[dst] = T
    for req in ("Tr_velo_cam", "Tr_imu_velo"):
        if req not in calib:
            raise ValueError(
                f"{path}: missing '{req}' (or its '_to_' spelling) — "
                f"expected KITTI tracking calib keys P2 P3 R_rect "
                f"Tr_velo_cam Tr_imu_velo (keys present: {sorted(out)})"
            )
    return calib


def oxts_to_poses(oxts: np.ndarray) -> np.ndarray:
    """[F, >=6] oxts rows -> [F, 4, 4] IMU-to-world poses (devkit mercator)."""
    lat, lon, alt = oxts[:, 0], oxts[:, 1], oxts[:, 2]
    roll, pitch, yaw = oxts[:, 3], oxts[:, 4], oxts[:, 5]
    scale = np.cos(lat[0] * np.pi / 180.0)
    tx = scale * lon * np.pi / 180.0 * EARTH_RADIUS
    ty = scale * EARTH_RADIUS * np.log(np.tan((90.0 + lat) * np.pi / 360.0))
    tz = alt
    poses = np.zeros((len(oxts), 4, 4))
    for i in range(len(oxts)):
        cr, sr = np.cos(roll[i]), np.sin(roll[i])
        cp, sp = np.cos(pitch[i]), np.sin(pitch[i])
        cy, sy = np.cos(yaw[i]), np.sin(yaw[i])
        Rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
        Ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
        Rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
        poses[i, :3, :3] = Rz @ Ry @ Rx
        poses[i, :3, 3] = [tx[i], ty[i], tz[i]]
        poses[i, 3, 3] = 1.0
    # re-origin at the first frame (keeps coordinates small; the loader
    # re-centers at the mean anyway, data/waymo.py:135-137)
    return np.linalg.inv(poses[0]) @ poses


def camera_transforms(calib):
    """Per-camera K [3,3] and cam-to-ego(IMU) [4,4] for cams {0, 1}."""
    R_rect4 = np.eye(4)
    R_rect4[:3, :3] = calib["R_rect"]
    velo_from_imu = calib["Tr_imu_velo"]
    cam0rect_from_imu = R_rect4 @ calib["Tr_velo_cam"] @ velo_from_imu
    Ks, cam_to_ego = {}, {}
    for c, pkey in ((0, "P2"), (1, "P3")):
        P = calib[pkey]
        K = P[:3, :3]
        t = np.linalg.solve(K, P[:, 3])  # x_rect_c = x_rect0 + t
        T_c = np.eye(4)
        T_c[:3, 3] = t
        cam_from_imu = T_c @ cam0rect_from_imu
        Ks[c] = K
        cam_to_ego[c] = np.linalg.inv(cam_from_imu)
    return Ks, cam_to_ego, cam0rect_from_imu


def parse_labels(path: str):
    """label_02 rows -> list of dicts (skips DontCare)."""
    rows = []
    if not os.path.exists(path):
        return rows
    with open(path) as f:
        for line in f:
            t = line.split()
            if len(t) < 17 or t[2] == "DontCare":
                continue
            rows.append(
                dict(
                    frame=int(t[0]),
                    track_id=int(t[1]),
                    kitti_type=t[2],
                    alpha=float(t[5]),
                    h=float(t[10]),
                    w=float(t[11]),
                    l=float(t[12]),
                    loc=np.array([float(t[13]), float(t[14]), float(t[15])]),
                    ry=float(t[16]),
                )
            )
    return rows


def convert(kitti_dir: str, seq: str, out_dir: str, start: int = 0, end: int | None = None):
    calib = read_calib(os.path.join(kitti_dir, "calib", f"{seq}.txt"))
    oxts = np.loadtxt(os.path.join(kitti_dir, "oxts", f"{seq}.txt")).reshape(-1, 30)
    imu_poses = oxts_to_poses(oxts)
    Ks, cam_to_ego, cam0rect_from_imu = camera_transforms(calib)
    imu_from_cam0rect = np.linalg.inv(cam0rect_from_imu)
    imu_from_velo = np.linalg.inv(calib["Tr_imu_velo"])

    frame_files = sorted(glob(os.path.join(kitti_dir, CAM_DIRS[0], seq, "*.png")))
    num_frames_all = len(frame_files)
    if end is None:
        end = num_frames_all - 1
    end = min(end, num_frames_all - 1, len(imu_poses) - 1)
    frames = list(range(start, end + 1))

    os.makedirs(out_dir, exist_ok=True)
    for sub in ("images", "ego_pose", "intrinsics", "extrinsics", "track"):
        os.makedirs(os.path.join(out_dir, sub), exist_ok=True)

    # calibration (Waymo layout: 9-vector intrinsics, 4x4 cam-to-ego;
    # data/waymo.py:115-122)
    sizes = {}
    for c in (0, 1):
        K = Ks[c]
        np.savetxt(
            os.path.join(out_dir, "intrinsics", f"{c}.txt"),
            np.array([K[0, 0], K[1, 1], K[0, 2], K[1, 2], 0, 0, 0, 0, 0]),
        )
        np.savetxt(os.path.join(out_dir, "extrinsics", f"{c}.txt"), cam_to_ego[c])

    timestamps = {"FRAME": {}}
    for c in (0, 1):
        timestamps[CAM_NAMES[c]] = {}

    # images + poses + timestamps (re-indexed to 0..len(frames)-1 so the
    # on-disk scene is dense; KITTI cameras are frame-synchronous, so the
    # per-image pose equals the frame pose)
    for fi, f in enumerate(frames):
        pose = imu_poses[f]
        np.savetxt(os.path.join(out_dir, "ego_pose", f"{fi:06d}.txt"), pose)
        t = f / KITTI_FPS
        timestamps["FRAME"][f"{fi:06d}"] = t
        for c in (0, 1):
            src = os.path.join(kitti_dir, CAM_DIRS[c], seq, f"{f:06d}.png")
            dst = os.path.join(out_dir, "images", f"{fi:06d}_{c}.png")
            shutil.copyfile(src, dst)
            np.savetxt(os.path.join(out_dir, "ego_pose", f"{fi:06d}_{c}.txt"), pose)
            timestamps[CAM_NAMES[c]][f"{fi:06d}"] = t
            if c not in sizes:
                sizes[c] = image_size(src)

    with open(os.path.join(out_dir, "timestamps.json"), "w") as f:
        json.dump(timestamps, f)

    # ---- tracklets -> track/track_info.txt + track_camera_vis.json ----
    labels = parse_labels(os.path.join(kitti_dir, "label_02", f"{seq}.txt"))
    # world positions per (track, frame) for the speed column
    world_pos: dict[int, dict[int, np.ndarray]] = {}
    per_frame: dict[int, list] = {fi: [] for fi in range(len(frames))}
    for row in labels:
        if row["frame"] not in frames:
            continue
        fi = row["frame"] - start
        cls = KITTI_CLASS_MAP.get(row["kitti_type"], "misc")
        # rectified-cam0 bottom-center -> ego frame, then lift by h/2
        # along ego +z (IMU z is up) — NOT along cam -y, which tilts the
        # center whenever the camera is pitched relative to the IMU
        c_ego = (imu_from_cam0rect @ np.append(row["loc"], 1.0))[:3]
        c_ego = c_ego + np.array([0.0, 0.0, row["h"] / 2.0])
        # box x-axis in rect coords is (cos ry, 0, -sin ry); the shared
        # track_info format stores a z-yaw only (Waymo convention), so
        # the axis is projected onto the ego xy-plane — any camera
        # pitch/roll vs the IMU makes converted boxes approximate by
        # that residual tilt (small for KITTI's near-level rigs)
        d_rect = np.array([np.cos(row["ry"]), 0.0, -np.sin(row["ry"])])
        d_ego = imu_from_cam0rect[:3, :3] @ d_rect
        heading = float(np.arctan2(d_ego[1], d_ego[0]))
        w_pos = (imu_poses[row["frame"]] @ np.append(c_ego, 1.0))[:3]
        world_pos.setdefault(row["track_id"], {})[fi] = w_pos
        per_frame[fi].append(
            dict(
                track_id=row["track_id"],
                cls=cls,
                alpha=row["alpha"],
                h=row["h"],
                w=row["w"],
                l=row["l"],
                center=c_ego,
                heading=heading,
            )
        )

    header = (
        "frame_id track_id object_class alpha box_height box_width "
        "box_length box_center_x box_center_y box_center_z box_heading speed"
    )
    lines = [header]
    camera_vis: dict[str, dict[str, list]] = {}
    for fi in range(len(frames)):
        pose = imu_poses[frames[fi]]
        for box in per_frame[fi]:
            tid = box["track_id"]
            tp = world_pos[tid]
            fis = sorted(tp)
            j = fis.index(fi)
            if len(fis) > 1:
                a, b = (fis[j - 1], fi) if j > 0 else (fi, fis[j + 1])
                speed = float(
                    np.linalg.norm(tp[b] - tp[a]) / ((b - a) / KITTI_FPS)
                )
            else:
                speed = 0.0
            lines.append(
                f"{fi} {tid} {box['cls']} {box['alpha']:.4f} "
                f"{box['h']:.4f} {box['w']:.4f} {box['l']:.4f} "
                f"{box['center'][0]:.4f} {box['center'][1]:.4f} "
                f"{box['center'][2]:.4f} {box['heading']:.6f} {speed:.4f}"
            )
            # camera visibility: project all 8 box corners into each cam
            # and mark it visible if ANY lands in the ±20% margin — a
            # center-only test drops large objects partially in frame
            # whose center sits outside the margin
            ch, cs = np.cos(box["heading"]), np.sin(box["heading"])
            R_box = np.array([[ch, -cs, 0.0], [cs, ch, 0.0], [0.0, 0.0, 1.0]])
            half = 0.5 * np.array([box["l"], box["w"], box["h"]])
            signs = np.array(
                [[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)]
            )
            corners = box["center"] + (signs * half) @ R_box.T  # [8, 3]
            vis = []
            for c in (0, 1):
                cam_from_ego = np.linalg.inv(cam_to_ego[c])
                p = corners @ cam_from_ego[:3, :3].T + cam_from_ego[:3, 3]
                front = p[:, 2] > 0.1
                if not front.any():
                    continue
                uv = p[front] @ Ks[c].T
                u, v = uv[:, 0] / uv[:, 2], uv[:, 1] / uv[:, 2]
                Himg, Wimg = sizes[c]
                inside = (
                    (u >= -0.2 * Wimg)
                    & (u <= 1.2 * Wimg)
                    & (v >= -0.2 * Himg)
                    & (v <= 1.2 * Himg)
                )
                if inside.any():
                    vis.append(c)
            camera_vis.setdefault(str(tid), {})[str(fi)] = vis

    with open(os.path.join(out_dir, "track", "track_info.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    with open(os.path.join(out_dir, "track", "track_camera_vis.json"), "w") as f:
        json.dump(camera_vis, f)

    # ---- velodyne -> pointcloud.npz (vehicle-frame xyz + projections) ----
    pts3d, pts2d = {}, {}
    for fi, f in enumerate(frames):
        velo_path = os.path.join(kitti_dir, "velodyne", seq, f"{f:06d}.bin")
        if os.path.exists(velo_path):
            pts = np.fromfile(velo_path, np.float32).reshape(-1, 4)[:, :3]
        else:
            pts = np.zeros((0, 3), np.float32)
        ph = np.concatenate([pts, np.ones_like(pts[:, :1])], axis=-1)
        pts_ego = (ph @ imu_from_velo.T)[:, :3].astype(np.float32)
        proj = np.full((len(pts), 6), -1, np.int16)
        proj[:, 4:] = 0
        filled = np.zeros(len(pts), bool)
        for c in (0, 1):
            cam_from_ego = np.linalg.inv(cam_to_ego[c])
            pc = np.concatenate([pts_ego, np.ones_like(pts_ego[:, :1])], -1) @ cam_from_ego.T
            z = pc[:, 2]
            with np.errstate(divide="ignore", invalid="ignore"):
                u = Ks[c][0, 0] * pc[:, 0] / z + Ks[c][0, 2]
                v = Ks[c][1, 1] * pc[:, 1] / z + Ks[c][1, 2]
            Himg, Wimg = sizes[c]
            ok = (z > 0.5) & (u >= 0) & (u < Wimg) & (v >= 0) & (v < Himg) & ~filled
            proj[ok, 0] = c
            proj[ok, 1] = u[ok].astype(np.int16)
            proj[ok, 2] = v[ok].astype(np.int16)
            filled |= ok
        keep = filled  # only camera-visible points carry usable color
        pts3d[fi] = pts_ego[keep]
        pts2d[fi] = proj[keep]

    np.savez(
        os.path.join(out_dir, "pointcloud.npz"),
        pointcloud=np.array(pts3d, dtype=object),
        camera_projection=np.array(pts2d, dtype=object),
    )
    print(f"[kitti_converter] wrote {len(frames)} frames x 2 cams to {out_dir}")
    return out_dir


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--kitti_dir", required=True, help="KITTI tracking training/ dir")
    ap.add_argument("--seq", required=True, help="sequence id, e.g. 0002")
    ap.add_argument("--out_dir", required=True)
    ap.add_argument("--start", type=int, default=0)
    ap.add_argument("--end", type=int, default=None)
    args = ap.parse_args(argv)
    return convert(args.kitti_dir, args.seq, args.out_dir, args.start, args.end)


if __name__ == "__main__":
    main()
