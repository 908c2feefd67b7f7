# Port of the repo's root script/waymo/generate_lidar_depth.py (lines 1-99): the
# depths and the z-buffer on a torch device in float64, image sizes from the PNG
# header (utils/image_io.image_size) in place of cv2.imread.
"""Sparse LiDAR depth maps from a converted Waymo sequence.

Port of the reference preprocessing step (ref:
script/waymo/generate_lidar_depth.py:33-115): for every image, z-buffer
the LiDAR points that project into it (both stored camera projections)
and save `{mask, value}` npy files consumed as the `lidar_depth`
guidance (lib/datasets/waymo_full_readers.py:134-142).

Usage:
  python -m street_gaussians_torch.script.waymo.generate_lidar_depth --datadir <seq_dir> [--device cpu]

Each point's depth (the camera's z of its vehicle-frame position, float64
as numpy promotes it) and the per-pixel minimum (`scatter_reduce_` amin:
exact in any order) run on the CUDA card unless --device says otherwise;
the masks are the root script's and the values its float64 minima cast
to float32.
"""

from __future__ import annotations

import argparse
import os
import time
from glob import glob

import numpy as np
import torch

from street_gaussians_torch._device import resolve_device
from street_gaussians_torch.utils.image_io import image_size

F32_MAX = float(np.finfo(np.float32).max)


def image_filename_to_cam(x):
    return int(x.split(".")[0][-1])


def image_filename_to_frame(x):
    return int(x.split(".")[0][:6])


def load_calibration(datadir):
    intrinsics, extrinsics = [], []
    for i in range(5):
        intr = np.loadtxt(os.path.join(datadir, "intrinsics", f"{i}.txt"))
        fx, fy, cx, cy = intr[0], intr[1], intr[2], intr[3]
        intrinsics.append(np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]]))
        extrinsics.append(np.loadtxt(os.path.join(datadir, "extrinsics", f"{i}.txt")))
    return extrinsics, intrinsics


def depth_map(points_xyz: torch.Tensor, coords: np.ndarray, w2c: np.ndarray, h: int, w: int):
    """The root script's z-buffer of one image (generate_lidar_depth.py:
    60-85): points_xyz [N, 3] float32 (on the device), coords [N, 2]
    int (x, y) of their projections, w2c [4, 4] float64 -> (mask [h, w]
    bool, value [mask.sum()] float32), both numpy. The depth is
    ((w2c[2, 0] x + w2c[2, 1] y) + w2c[2, 2] z) + w2c[2, 3], numpy's
    order for a [N, 4] @ [4, 4] row; points at depth 0 or behind are
    dropped; a pixel keeps its nearest point."""
    dev = points_xyz.device
    p = points_xyz.double()
    r = [float(v) for v in w2c[2]]
    depth = ((r[0] * p[:, 0] + r[1] * p[:, 1]) + r[2] * p[:, 2]) + r[3]
    valid = depth > 0.0
    c = torch.as_tensor(coords, device=dev)[valid].long()
    cx = c[:, 0].clamp(0, w - 1)
    cy = c[:, 1].clamp(0, h - 1)
    buf = torch.full((h * w,), F32_MAX, dtype=torch.float64, device=dev)
    buf.scatter_reduce_(0, cy * w + cx, depth[valid], "amin", include_self=True)
    buf[buf >= F32_MAX - 1e-5] = 0
    nz = buf != 0
    return nz.reshape(h, w).cpu().numpy(), buf[nz].float().cpu().numpy()


def generate_lidar_depth(datadir, device=None):
    """Write lidar_depth/<image>.npy for every image of datadir. Returns
    the seconds it took and the images written."""
    t0 = time.perf_counter()
    dev = resolve_device(device)
    save_dir = os.path.join(datadir, "lidar_depth")
    os.makedirs(save_dir, exist_ok=True)

    image_files = sorted(
        glob(os.path.join(datadir, "images", "*.jpg"))
        + glob(os.path.join(datadir, "images", "*.png"))
    )
    data = np.load(os.path.join(datadir, "pointcloud.npz"), allow_pickle=True)
    pts3d_dict = data["pointcloud"].item()
    pts2d_dict = data["camera_projection"].item()
    extrinsics, _ = load_calibration(datadir)

    on_device = {}  # frame -> its points on the device, uploaded once
    for image_filename in image_files:
        h, w = image_size(image_filename)
        base = os.path.basename(image_filename)
        frame = image_filename_to_frame(base)
        cam = image_filename_to_cam(base)

        raw_3d = pts3d_dict[frame]
        raw_2d = np.asarray(pts2d_dict[frame])
        num_pts = raw_3d.shape[0]
        if raw_2d.shape[-1] >= 6:
            # both stored projections (generate_lidar_depth.py:63-66)
            pts_idx = np.repeat(np.arange(num_pts), 2)
            raw_2d = raw_2d.reshape(-1, 3)
        else:
            pts_idx = np.arange(num_pts)
        mask = raw_2d[:, 0] == cam
        if frame not in on_device:
            on_device = {frame: torch.as_tensor(np.ascontiguousarray(raw_3d), device=dev)}
        points_xyz = on_device[frame][torch.as_tensor(pts_idx[mask], device=dev)]
        w2c = np.linalg.inv(extrinsics[cam])
        coords = raw_2d[mask][:, 1:3].round().astype(np.int32)
        mask_img, value = depth_map(points_xyz, coords, w2c, h, w)
        np.save(
            os.path.join(save_dir, f"{base.split('.')[0]}.npy"),
            {"mask": mask_img, "value": value},
        )
    print(f"wrote lidar depth for {len(image_files)} images to {save_dir}")
    return {"seconds": time.perf_counter() - t0, "images": len(image_files)}


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--datadir", required=True, type=str)
    parser.add_argument("--device", default=None, help="default: the CUDA card")
    args = parser.parse_args(argv)
    return generate_lidar_depth(args.datadir, device=args.device)


if __name__ == "__main__":
    main()
