"""Camera model, projection matrices and per-pixel rays.

Port of street_gaussians_tpu/utils/camera.py. Conventions:
  * w2c is a 4x4 world->camera matrix: p_cam = w2c[:3,:3] @ p + w2c[:3,3]
  * proj is the 4x4 OpenGL-style projection built from K
  * full_proj = proj @ w2c; NDC = clip.xyz / (clip.w + 1e-7)
  * pixel center x of NDC v: ((v + 1) * W - 1) / 2
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from street_gaussians_torch._device import resolve_device


def projection_matrix_from_K(
    K: np.ndarray, H: int, W: int, znear: float = 0.01, zfar: float = 100.0
) -> np.ndarray:
    """Intrinsics K [3,3] -> 4x4 projection."""
    fx, fy = K[0, 0], K[1, 1]
    cx, cy = K[0, 2], K[1, 2]
    s = K[0, 1]
    P = np.zeros((4, 4), dtype=np.float32)
    P[0, 0] = 2.0 * fx / W
    P[0, 1] = 2.0 * s / W
    P[0, 2] = -1.0 + 2.0 * (cx / W)
    P[1, 1] = 2.0 * fy / H
    P[1, 2] = -1.0 + 2.0 * (cy / H)
    P[2, 2] = (zfar + znear) / (zfar - znear)
    P[2, 3] = -2.0 * zfar * znear / (zfar - znear)
    P[3, 2] = 1.0
    return P


@dataclasses.dataclass(frozen=True)
class Camera:
    """Everything a render needs of one camera. Tensors live on the
    render device; H, W and the per-camera indices are Python ints."""

    w2c: torch.Tensor  # [4,4] world->camera
    proj: torch.Tensor  # [4,4] intrinsic projection
    cam_center: torch.Tensor  # [3] camera origin in world
    K: torch.Tensor  # [3,3] pixel intrinsics
    H: int
    W: int
    frame: int = 0  # dataset frame index
    timestamp: float = 0.0  # normalized [0,1] time
    cam_id: int = 0  # sensor index
    image_id: int = 0  # global image index

    @property
    def full_proj(self) -> torch.Tensor:
        return self.proj @ self.w2c

    @property
    def tan_fovx(self) -> torch.Tensor:
        return self.W / (2.0 * self.K[0, 0])

    @property
    def tan_fovy(self) -> torch.Tensor:
        return self.H / (2.0 * self.K[1, 1])

    @property
    def focal_x(self) -> torch.Tensor:
        return self.K[0, 0]

    @property
    def focal_y(self) -> torch.Tensor:
        return self.K[1, 1]


def make_camera(
    K: np.ndarray,
    w2c: np.ndarray,
    H: int,
    W: int,
    znear: float = 0.01,
    zfar: float = 1000.0,
    frame: int = 0,
    timestamp: float = 0.0,
    cam_id: int = 0,
    image_id: int = 0,
    device=None,
) -> Camera:
    """Build a camera from numpy intrinsics/extrinsics on `device`."""
    device = resolve_device(device)
    K = np.asarray(K, np.float32)
    w2c = np.asarray(w2c, np.float32)
    c2w = np.linalg.inv(w2c)
    proj = projection_matrix_from_K(K, H, W, znear, zfar)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)  # noqa: E731
    return Camera(
        w2c=t(w2c),
        proj=t(proj),
        cam_center=t(c2w[:3, 3]),
        K=t(K),
        H=int(H),
        W=int(W),
        frame=int(frame),
        timestamp=float(timestamp),
        cam_id=int(cam_id),
        image_id=int(image_id),
    )


def camera_rays(cam: Camera, downsample: int = 1) -> torch.Tensor:
    """Per-pixel unit ray directions in world frame, [H, W, 3].

    downsample: > 1 returns a [ceil(H/ds), ceil(W/ds), 3] ray grid whose
    sample points sit at the centers of ds x ds pixel groups (continuous
    coord (j + 0.5) * ds), the eval-path half-res sky grid. The
    train-time jitter and the row band of tile-sharded rendering come
    with later slices."""
    H, W = cam.H, cam.W
    dev = cam.K.device
    if downsample > 1:
        ds = float(downsample)
        Hs = -(-H // downsample)
        Ws = -(-W // downsample)
        xs = (torch.arange(Ws, dtype=torch.float32, device=dev) + 0.5) * ds - 0.5
        ys = (torch.arange(Hs, dtype=torch.float32, device=dev) + 0.5) * ds - 0.5
        x = xs[None, :].expand(Hs, Ws)
        y = ys[:, None].expand(Hs, Ws)
    else:
        x = torch.arange(W, dtype=torch.float32, device=dev)[None, :].expand(H, W)
        y = torch.arange(H, dtype=torch.float32, device=dev)[:, None].expand(H, W)
    pix = torch.stack([x + 0.5, y + 0.5, torch.ones_like(x)], dim=-1)
    Kinv = torch.linalg.inv(cam.K)
    dirs_cam = pix @ Kinv.T
    c2w_rot = cam.w2c[:3, :3].T
    dirs_world = dirs_cam @ c2w_rot.T
    return dirs_world / torch.linalg.norm(dirs_world, dim=-1, keepdim=True)
