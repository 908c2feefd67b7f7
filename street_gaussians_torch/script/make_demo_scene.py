"""Build a self-consistent demo scene: a Waymo-format sequence whose images
are RENDERED from a known ground-truth Gaussian scene, so that training
has a real reconstruction target (PSNR must climb toward the ground
truth's renders).

    python -m street_gaussians_torch.script.make_demo_scene --out DIR [--frames 8] [--cameras 0]
        [--height 320] [--width 480] [--points 20000] [--seed 0] [--device cpu]

Port of the repo's root script/make_demo_scene.py, drawing from
np.random.default_rng(seed) in its order: the structured LiDAR cloud, the
per-frame projections, then one random image per file. Steps: write a
synthetic Waymo-format sequence (geometry, tracks, LiDAR), load it
(split_train 1), build a ground-truth model from the LiDAR init with
opaque Gaussians (opacity logit 2) whose colours the loader sampled from
the random images, render every camera through render_frame at eval
settings, composite the constant sky colour over 1 - acc, and overwrite
the images (PNG, utils/image_io) and the sky masks (acc < 0.05), and
write lidar_depth (depth / max(acc, 0.01) where acc > 0.5). Training then
starts from the standard init (opacity 0.1, colours re-sampled from the
rendered images) and must recover the ground truth's appearance.
Runs on the CUDA card unless --device says otherwise.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import shutil

import numpy as np
import torch

from street_gaussians_torch._device import resolve_device
from street_gaussians_torch.utils.image_io import imwrite

SKY_COLOR = (0.55, 0.7, 0.9)
EVAL_STEP = 10**9


def dense_points(rng: np.random.Generator, n: int) -> np.ndarray:
    """Ground-plane strips, two walls and scattered blobs: structure the
    renderer can reconstruct. [n, 3] float32 in the world frame."""
    n1, n2, n3 = n // 2, n // 4, n - n // 2 - n // 4
    ground = np.stack(
        [rng.uniform(3, 60, n1), rng.uniform(-18, 18, n1), rng.uniform(-0.1, 0.1, n1)],
        axis=-1,
    )
    wall = np.stack(
        [rng.uniform(3, 60, n2), rng.choice([-18, 18], n2) + rng.normal(0, 0.2, n2),
         rng.uniform(0, 6, n2)],
        axis=-1,
    )
    k = 24
    centers = np.stack(
        [rng.uniform(6, 55, k), rng.uniform(-14, 14, k), rng.uniform(0.3, 2.5, k)],
        axis=-1,
    )
    blobs = centers[rng.integers(0, k, n3)] + rng.normal(0, 0.7, (n3, 3))
    return np.concatenate([ground, wall, blobs]).astype(np.float32)


def make_demo_scene(out: str, frames: int = 8, cameras=(0,), height: int = 320, width: int = 480,
                    points: int = 20000, seed: int = 0, device=None) -> dict:
    """Write the scene under `out` (see the module's docstring). Returns
    the ground truth's acc [H, W] by image name (the sky masks and the
    LiDAR depth masks are thresholds of it)."""
    from street_gaussians_torch.config import derive_paths, load_config
    from street_gaussians_torch.data.dataset import load_waymo_scene
    from street_gaussians_torch.data.synthetic_waymo import write_synthetic_waymo
    from street_gaussians_torch.models.renderer import RenderOptions, SceneParams, render_frame

    device = resolve_device(device)
    cameras = list(cameras)
    rng = np.random.default_rng(seed)

    # 1. synthetic geometry in the converter's on-disk format, its LiDAR
    #    replaced by the dense structured cloud (the vehicle frame per
    #    frame: the ego's x-motion subtracted)
    write_synthetic_waymo(out, num_frames=frames, cameras=tuple(cameras), seed=seed)
    pts3d, pts2d = {}, {}
    world = dense_points(rng, points)
    for f in range(frames):
        veh = world.copy()
        veh[:, 0] -= 2.0 * f
        veh = veh[(veh[:, 0] > 2.0) & (veh[:, 0] < 70.0)]
        n = veh.shape[0]
        proj = np.zeros((n, 6), np.int16)
        proj[:, 0] = rng.choice(cameras, n)
        proj[:, 1] = rng.integers(0, width, n)
        proj[:, 2] = rng.integers(0, height, n)
        proj[:, 3] = -1
        pts3d[f] = veh
        pts2d[f] = proj
    np.savez(
        os.path.join(out, "pointcloud.npz"),
        pointcloud=np.array(pts3d, dtype=object),
        camera_projection=np.array(pts2d, dtype=object),
    )

    # random images at the target size (the loader samples the initial
    # colours from them), the sky masks as the top quarter, the
    # intrinsics for the new size
    img_dir = os.path.join(out, "images")
    for fn in os.listdir(img_dir):
        imwrite(os.path.join(img_dir, fn), rng.integers(0, 255, (height, width, 3), dtype=np.uint8))
    for sub in ("sky_mask", "lidar_depth"):
        d = os.path.join(out, sub)
        for fn in os.listdir(d):
            os.remove(os.path.join(d, fn))
    for fn in os.listdir(img_dir):
        sky = np.zeros((height, width), np.uint8)
        sky[: height // 4] = 255
        imwrite(os.path.join(out, "sky_mask", fn), sky)
    for c in range(5):
        np.savetxt(
            os.path.join(out, "intrinsics", f"{c}.txt"),
            np.array([300.0, 300.0, width / 2, height / 2, 0, 0, 0, 0, 0]),
        )

    # 2. load, build the ground-truth model, render, overwrite the images
    cfg = load_config()
    cfg.source_path = out
    cfg.model_path = os.path.join(out, "_gt_build")
    derive_paths(cfg)
    cfg.data.type = "Waymo"
    cfg.data.split_train = 1
    cfg.data.cameras = cameras
    scene = load_waymo_scene(cfg, device=device)

    g = scene.params_init
    gt_g = dataclasses.replace(
        g, opacity_logit=torch.full_like(g.opacity_logit, 2.0), feat_dc=g.feat_dc.clone()
    )
    gt_params = SceneParams(gt_g, scene.pose_params_init, None, None, None)
    opts = RenderOptions(mode="eval", tile_capacity=1024, instance_capacity=2**19, white_background=False)
    sky_col = np.array(SKY_COLOR)
    accs = {}
    os.makedirs(os.path.join(out, "lidar_depth"), exist_ok=True)
    for view in scene.all_views:
        with torch.no_grad():
            r = render_frame(gt_params, scene.aux_init, scene.table, scene.pose_data, view.frame_input,
                             EVAL_STEP, opts=opts)
        rgb = np.clip(r["rgb"].cpu().numpy(), 0, 1)
        acc = r["acc"].cpu().numpy()
        depth = r["depth"].cpu().numpy()
        accs[view.image_name] = acc
        # the sky region: a constant light blue, so the sky model has a target
        rgb = rgb + (1 - acc[..., None]) * sky_col[None, None]
        imwrite(os.path.join(img_dir, f"{view.image_name}.png"),
                (np.clip(rgb, 0, 1) * 255).astype(np.uint8)[..., ::-1])
        # the sky mask from the ground truth's transmittance (what the
        # sky BCE loss expects)
        imwrite(os.path.join(out, "sky_mask", f"{view.image_name}.png"), ((acc < 0.05) * 255).astype(np.uint8))
        # 3. LiDAR depth from the ground truth's expected depth
        depth = depth / np.maximum(acc, 1e-2)
        mask = acc > 0.5
        np.save(os.path.join(out, "lidar_depth", f"{view.image_name}.npy"),
                {"mask": mask, "value": depth[mask].astype(np.float32)})

    shutil.rmtree(cfg.model_path, ignore_errors=True)
    print(f"demo scene written to {out} ({frames} frames x {len(cameras)} cams @ {width}x{height})")
    return accs


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", required=True)
    parser.add_argument("--frames", type=int, default=8)
    parser.add_argument("--cameras", type=int, nargs="+", default=[0])
    parser.add_argument("--height", type=int, default=320)
    parser.add_argument("--width", type=int, default=480)
    parser.add_argument("--points", type=int, default=20000)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default=None, help="default: the CUDA card")
    args = parser.parse_args(argv)
    make_demo_scene(args.out, args.frames, args.cameras, args.height, args.width, args.points, args.seed,
                    args.device)


if __name__ == "__main__":
    main()
