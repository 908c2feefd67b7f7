# Port of street_gaussians_tpu/data/static_readers.py.
"""Colmap + Blender (NeRF-synthetic) scene readers — the standard
single-cloud 3DGS loaders (ref: lib/datasets/colmap_readers.py:1-104,
blender_readers.py:1-83). These produce background-only Scenes (no
actors/sky), the plain-3DGS capability of the framework, on `device`.
Images are read by utils/image_io (PNG without cv2).
"""

from __future__ import annotations

import json
import math
import os
from typing import List, Tuple

import numpy as np
import torch

from street_gaussians_torch._device import resolve_device
from street_gaussians_torch.config import Config
from street_gaussians_torch.data import colmap_model
from street_gaussians_torch.data.dataset import CameraView, Scene, _resize_shape
from street_gaussians_torch.models import gaussians as G
from street_gaussians_torch.models.renderer import FrameInput
from street_gaussians_torch.utils import ply as ply_utils
from street_gaussians_torch.utils.camera import make_camera
from street_gaussians_torch.utils.image_io import imread
from street_gaussians_torch.utils.pointcloud import nerfpp_norm, sphere_norm


def _read_colmap_text_cameras(path: str):
    cams = {}
    with open(path) as f:
        for line in f:
            if line.startswith("#") or not line.strip():
                continue
            e = line.split()
            cams[int(e[0])] = colmap_model.ColmapCamera(
                int(e[0]), e[1], int(e[2]), int(e[3]), np.array([float(x) for x in e[4:]])
            )
    return cams


def _read_colmap_text_images(path: str):
    """images.txt: two lines per image — pose line + (possibly empty)
    2D-points line — so blank lines must be kept for the pairing."""
    imgs = {}
    with open(path) as f:
        lines = [l.rstrip("\n") for l in f if not l.startswith("#")]
    for i in range(0, len(lines) - len(lines) % 2, 2):
        if not lines[i].strip():
            continue
        e = lines[i].split()
        imgs[int(e[0])] = colmap_model.ColmapImage(
            int(e[0]),
            np.array([float(x) for x in e[1:5]]),
            np.array([float(x) for x in e[5:8]]),
            int(e[8]),
            e[9],
        )
    return imgs


def _build_static_scene(
    cfg: Config,
    cam_entries: List[Tuple[np.ndarray, np.ndarray, str, int, int, str]],
    points: np.ndarray,
    colors: np.ndarray,
    split_test: int,
    device,
) -> Scene:
    """cam_entries: (K, c2w, image_path, width, height, name)."""
    # nerf++ norm from camera centers (base_readers.py:30-55)
    centers = np.stack([c2w[:3, 3] for _, c2w, *_ in cam_entries])
    scene_center, scene_radius = nerfpp_norm(centers)
    if cfg.data.get("extent"):
        scene_radius = float(cfg.data.extent)
    sphere_center, sphere_radius = sphere_norm(points)

    mg = cfg.model.gaussian
    params, aux, table = G.pack_scene(
        {"background": points},
        {"background": colors},
        scene_center=scene_center,
        scene_radius=scene_radius,
        sphere_center=sphere_center,
        sphere_radius=sphere_radius,
        sh_degree_bkgd=mg.get("sh_degree_background", mg.sh_degree),
        sh_degree_obj=mg.get("sh_degree_obj", mg.sh_degree),
        num_classes=cfg.data.get("num_classes", 20),
        use_semantic=cfg.data.get("use_semantic", False),
        background_growth=cfg.capacity.background_growth,
        round_to=cfg.capacity.round_to,
        device=device,
    )

    train_views, test_views = [], []
    for i, (K, c2w, image_path, width, height, name) in enumerate(cam_entries):
        W, H, scale = _resize_shape(width, height)
        Ks = K.copy()
        Ks[:2] *= scale
        w2c = np.linalg.inv(c2w)
        is_val = split_test > 0 and (i % split_test == 0)
        cam_dev = make_camera(Ks, w2c, H, W, frame=i, timestamp=0.0, image_id=i, device=device)
        view = CameraView(
            frame_input=FrameInput(
                cam=cam_dev,
                ego_quat=torch.tensor([1.0, 0.0, 0.0, 0.0], device=device),
                ego_rotmat=torch.eye(3, device=device),
                ego_trans=torch.zeros(3, device=device),
                interp=None,
            ),
            image_path=image_path,
            H=H,
            W=W,
            cam=0,
            frame=i,
            frame_idx=i,
            timestamp=0.0,
            is_val=is_val,
            image_name=name,
        )
        (test_views if is_val else train_views).append(view)

    return Scene(
        table=table,
        params_init=params,
        aux_init=aux,
        pose_data=None,
        pose_params_init=None,
        train_views=train_views,
        test_views=test_views,
        metadata=dict(
            num_images=len(cam_entries),
            num_cams=1,
            num_frames=len(cam_entries),
            scene_center=scene_center,
            scene_radius=scene_radius,
        ),
    )


def load_colmap_scene(cfg: Config, device=None) -> Scene:
    """(ref: colmap_readers.py:57-104 readColmapSceneInfo)"""
    device = resolve_device(device)
    path = cfg.source_path
    base = os.path.join(path, "sparse/0")
    if not os.path.exists(base):
        base = os.path.join(path, "sparse")

    if os.path.exists(os.path.join(base, "images.bin")):
        extr = colmap_model.read_images_binary(os.path.join(base, "images.bin"))
        intr = colmap_model.read_cameras_binary(os.path.join(base, "cameras.bin"))
    else:
        extr = _read_colmap_text_images(os.path.join(base, "images.txt"))
        intr = _read_colmap_text_cameras(os.path.join(base, "cameras.txt"))

    entries = []
    for key in sorted(extr, key=lambda k: extr[k].name):
        im = extr[key]
        cam = intr[im.camera_id]
        if cam.model == "SIMPLE_PINHOLE":
            f, cx, cy = cam.params[:3]
            K = np.array([[f, 0, cx], [0, f, cy], [0, 0, 1]], np.float32)
        elif cam.model == "PINHOLE":
            fx, fy, cx, cy = cam.params[:4]
            K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float32)
        else:
            raise ValueError(
                "only undistorted PINHOLE/SIMPLE_PINHOLE COLMAP models supported"
            )
        R = colmap_model.qvec2rotmat(im.qvec)
        w2c = np.eye(4)
        w2c[:3, :3] = R
        w2c[:3, 3] = im.tvec
        c2w = np.linalg.inv(w2c)
        img_path = os.path.join(path, cfg.data.get("images", "images"), os.path.basename(im.name))
        entries.append(
            (K, c2w, img_path, cam.width, cam.height, os.path.basename(im.name).split(".")[0])
        )

    ply_path = os.path.join(base, "points3D.ply")
    if os.path.exists(ply_path):
        pts, cols, _ = ply_utils.read_points_ply(ply_path)
    else:
        pts, cols, _err = colmap_model.read_points3d(base)
        ply_utils.write_points_ply(ply_path, pts, cols)

    split_test = cfg.data.get("split_test", 8)
    return _build_static_scene(cfg, entries, pts, cols, split_test, device)


def load_blender_scene(cfg: Config, device=None) -> Scene:
    """(ref: blender_readers.py:50-83 readNerfSyntheticInfo)"""
    device = resolve_device(device)
    path = cfg.source_path
    white_background = cfg.data.get("white_background", False)
    entries = []

    def read_split(fname, start_idx):
        out = []
        with open(os.path.join(path, fname)) as f:
            contents = json.load(f)
        fovx = contents["camera_angle_x"]
        for idx, frame in enumerate(contents["frames"]):
            img_path = os.path.join(path, frame["file_path"] + ".png")
            img = imread(img_path, unchanged=True)
            h, w = img.shape[:2]
            # blender c2w is OpenGL (y up, z back); flip to COLMAP-style
            c2w = np.array(frame["transform_matrix"], np.float64)
            c2w[:3, 1:3] *= -1
            focal = 0.5 * w / math.tan(0.5 * fovx)
            K = np.array([[focal, 0, w / 2], [0, focal, h / 2], [0, 0, 1]], np.float32)
            name = os.path.basename(frame["file_path"])
            out.append((K, c2w, img_path, w, h, name))
        return out

    train_entries = read_split("transforms_train.json", 0)
    test_entries = read_split("transforms_test.json", len(train_entries))

    ply_path = os.path.join(path, "points3d.ply")
    if os.path.exists(ply_path):
        pts, cols, _ = ply_utils.read_points_ply(ply_path)
    else:
        # random init inside the synthetic bounds (blender_readers.py:63-73)
        num_pts = 100_000
        pts = (np.random.random((num_pts, 3)) * 2.6 - 1.3).astype(np.float32)
        cols = ((np.random.random((num_pts, 3)) / 255.0) * 0.28209479177387814 + 0.5).astype(
            np.float32
        )
        ply_utils.write_points_ply(ply_path, pts, cols)

    entries = train_entries + (test_entries if cfg.data.get("eval", True) else [])
    scene = _build_static_scene(cfg, entries, pts, cols, split_test=-1, device=device)
    if cfg.data.get("eval", True):
        n_train = len(train_entries)
        scene.test_views = scene.train_views[n_train:]
        scene.train_views = scene.train_views[:n_train]
        for v in scene.test_views:
            v.is_val = True
    return scene
