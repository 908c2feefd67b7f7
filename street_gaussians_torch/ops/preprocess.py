"""Per-Gaussian screen-space preprocess: projection, EWA 2D covariance,
conic, radius, tile rect, SH->RGB.

Port of street_gaussians_tpu/ops/preprocess.py, vectorized over the N
Gaussians. It replicates the reference CUDA preprocess: frustum cull at
view z <= 0.2, homogeneous divide with +1e-7, EWA Jacobian with the
1.3*tan_fov clamp and the 0.3 px low-pass, radius = ceil(3 sqrt(max
eigenvalue)), SH along the camera->mean direction (+0.5, clamped >= 0),
and the opacity-aware ellipse tile rect.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Union

import torch

from street_gaussians_torch.ops.sh_color import ShInputs, inputs_from_table, sh_color
from street_gaussians_torch.utils.trace import span

TILE = 16  # pixels per tile side
NEAR_Z = 0.2
LOWPASS = 0.3


class GaussianScreenData(NamedTuple):
    """Screen-space data for every (padded) Gaussian. All [N, ...]."""

    mean2d: torch.Tensor  # [N, 2] pixel coords
    depth: torch.Tensor  # [N] view-space z (0 for culled)
    conic: torch.Tensor  # [N, 3] inverse 2D covariance (a, b, c)
    radius: torch.Tensor  # [N] float pixel radius (0 for culled)
    rgb: torch.Tensor  # [N, 3] view-dependent color (clamped >= 0)
    opacity: torch.Tensor  # [N]
    valid: torch.Tensor  # [N] bool: survives culling
    rect_min: torch.Tensor  # [N, 2] int32 tile coords (x, y), inclusive
    rect_max: torch.Tensor  # [N, 2] int32 tile coords, exclusive
    tiles_touched: torch.Tensor  # [N] int32 (0 for culled)


def compute_cov3d(scale: torch.Tensor, quat: torch.Tensor, scale_mod: float = 1.0) -> torch.Tensor:
    """[..., 3] scale + [..., 4] quat -> [..., 6] packed upper-tri cov3D
    (xx, xy, xz, yy, yz, zz)."""
    s = scale * scale_mod
    q = quat / torch.clamp(torch.linalg.norm(quat, dim=-1, keepdim=True), min=1e-12)
    w, x, y, z = q.unbind(-1)
    r00 = 1.0 - 2.0 * (y * y + z * z)
    r01 = 2.0 * (x * y - w * z)
    r02 = 2.0 * (x * z + w * y)
    r10 = 2.0 * (x * y + w * z)
    r11 = 1.0 - 2.0 * (x * x + z * z)
    r12 = 2.0 * (y * z - w * x)
    r20 = 2.0 * (x * z - w * y)
    r21 = 2.0 * (y * z + w * x)
    r22 = 1.0 - 2.0 * (x * x + y * y)
    s0, s1, s2 = s[..., 0] ** 2, s[..., 1] ** 2, s[..., 2] ** 2
    return torch.stack(
        [
            r00 * r00 * s0 + r01 * r01 * s1 + r02 * r02 * s2,
            r00 * r10 * s0 + r01 * r11 * s1 + r02 * r12 * s2,
            r00 * r20 * s0 + r01 * r21 * s1 + r02 * r22 * s2,
            r10 * r10 * s0 + r11 * r11 * s1 + r12 * r12 * s2,
            r10 * r20 * s0 + r11 * r21 * s1 + r12 * r22 * s2,
            r20 * r20 * s0 + r21 * r21 * s1 + r22 * r22 * s2,
        ],
        dim=-1,
    )


def _compute_cov2d(mean3d, cov3d, w2c, focal_x, focal_y, tan_fovx, tan_fovy) -> torch.Tensor:
    """EWA projection of the 3D covariance to 2D: [N,3] = (cov_xx,
    cov_xy, cov_yy) with the 0.3 px low-pass added."""
    R = w2c[:3, :3]
    t = mean3d @ R.T + w2c[:3, 3]
    # culled points (z <= NEAR_Z) get a sanitized denominator, or their
    # inf/NaN would poison the vectorized math
    tz = torch.where(t[:, 2] > NEAR_Z, t[:, 2], 1.0)

    limx = 1.3 * tan_fovx
    limy = 1.3 * tan_fovy
    txtz = torch.clamp(t[:, 0] / tz, -limx, limx) * tz
    tytz = torch.clamp(t[:, 1] / tz, -limy, limy) * tz

    inv_z = 1.0 / tz
    inv_z2 = inv_z * inv_z
    j00 = focal_x * inv_z
    j02 = -focal_x * txtz * inv_z2
    j11 = focal_y * inv_z
    j12 = -focal_y * tytz * inv_z2

    a0 = j00 * R[0, 0] + j02 * R[2, 0]
    a1 = j00 * R[0, 1] + j02 * R[2, 1]
    a2 = j00 * R[0, 2] + j02 * R[2, 2]
    b0 = j11 * R[1, 0] + j12 * R[2, 0]
    b1 = j11 * R[1, 1] + j12 * R[2, 1]
    b2 = j11 * R[1, 2] + j12 * R[2, 2]

    xx, xy, xz, yy, yz, zz = cov3d.unbind(-1)
    u0 = xx * a0 + xy * a1 + xz * a2
    u1 = xy * a0 + yy * a1 + yz * a2
    u2 = xz * a0 + yz * a1 + zz * a2
    v0 = xx * b0 + xy * b1 + xz * b2
    v1 = xy * b0 + yy * b1 + yz * b2
    v2 = xz * b0 + yz * b1 + zz * b2
    c00 = a0 * u0 + a1 * u1 + a2 * u2
    c01 = b0 * u0 + b1 * u1 + b2 * u2
    c11 = b0 * v0 + b1 * v1 + b2 * v2
    return torch.stack([c00 + LOWPASS, c01, c11 + LOWPASS], dim=-1)


def _tile_index(x: torch.Tensor, grid: int) -> torch.Tensor:
    """int32(x) clamped to [0, grid], as XLA's saturating cast followed
    by the clip: clamp in float first (NaN -> 0) so no out-of-range
    float reaches the cast, whose result torch leaves undefined."""
    x = torch.nan_to_num(x, nan=0.0)
    return torch.clamp(x, 0.0, float(grid)).to(torch.int32)


def preprocess_gaussians(
    means3d: torch.Tensor,
    scales: torch.Tensor,
    quats: torch.Tensor,
    opacities: torch.Tensor,
    shs: Union[torch.Tensor, ShInputs, None],
    cam_w2c: torch.Tensor,
    cam_full_proj: torch.Tensor,
    cam_center: torch.Tensor,
    H: int,
    W: int,
    focal_x,
    focal_y,
    tan_fovx,
    tan_fovy,
    sh_degree: int = 3,
    scale_modifier: float = 1.0,
    alive: Optional[torch.Tensor] = None,
    colors_precomp: Optional[torch.Tensor] = None,
    cov3d_precomp: Optional[torch.Tensor] = None,
    max_tiles_per_gaussian: Optional[int] = None,
) -> GaussianScreenData:
    """Vectorized preprocess of N Gaussians for one camera.

    shs: the SH colour's inputs (ops.sh_color.ShInputs, compose_frame's),
    or one cloud's [N, K, 3] coefficients (band-major) evaluated at
    sh_degree, or None when colors_precomp [N, 3] is given. alive:
    optional [N] bool.
    max_tiles_per_gaussian: clamps the tile rect around the mean."""
    n = means3d.shape[0]
    grid_x = (W + TILE - 1) // TILE
    grid_y = (H + TILE - 1) // TILE

    t = means3d @ cam_w2c[:3, :3].T + cam_w2c[:3, 3]
    depth = t[:, 2]
    in_front = depth > NEAR_Z

    hom = means3d @ cam_full_proj[:3, :3].T + cam_full_proj[:3, 3]
    w_clip = means3d @ cam_full_proj[3, :3] + cam_full_proj[3, 3]
    w_den = w_clip + 1e-7
    inv_w = 1.0 / torch.where(in_front, w_den, 1.0)
    ndc = hom * inv_w[:, None]
    mean2d = torch.stack(
        [((ndc[:, 0] + 1.0) * W - 1.0) * 0.5, ((ndc[:, 1] + 1.0) * H - 1.0) * 0.5],
        dim=-1,
    )

    cov3d = compute_cov3d(scales, quats, scale_modifier) if cov3d_precomp is None else cov3d_precomp
    cov2d = _compute_cov2d(means3d, cov3d, cam_w2c, focal_x, focal_y, tan_fovx, tan_fovy)

    det = cov2d[:, 0] * cov2d[:, 2] - cov2d[:, 1] * cov2d[:, 1]
    det_valid = det != 0.0
    inv_det = 1.0 / torch.where(det_valid, det, 1.0)
    conic = torch.stack(
        [cov2d[:, 2] * inv_det, -cov2d[:, 1] * inv_det, cov2d[:, 0] * inv_det], dim=-1
    )

    mid = 0.5 * (cov2d[:, 0] + cov2d[:, 2])
    disc = torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    lambda1 = mid + disc
    r3 = 3.0 * torch.sqrt(torch.clamp(lambda1, min=0.0))
    radius = torch.ceil(r3)

    # opacity-aware ellipse AABB: a pixel blends only where
    # op * exp(-Q/2) >= 1/255, i.e. Q <= 2 ln(255 op); +0.01 px guard
    op_n = opacities.reshape(n)
    qmax = torch.clamp(2.0 * torch.log(torch.clamp(255.0 * op_n, min=1e-12)), min=0.0)
    hx = torch.minimum(r3, torch.sqrt(qmax * torch.clamp(cov2d[:, 0], min=0.0))) + 0.01
    hy = torch.minimum(r3, torch.sqrt(qmax * torch.clamp(cov2d[:, 2], min=0.0))) + 0.01
    rect_min = torch.stack(
        [
            _tile_index((mean2d[:, 0] - hx) / TILE, grid_x),
            _tile_index((mean2d[:, 1] - hy) / TILE, grid_y),
        ],
        dim=-1,
    )
    rect_max = torch.stack(
        [
            _tile_index((mean2d[:, 0] + hx + TILE - 1) / TILE, grid_x),
            _tile_index((mean2d[:, 1] + hy + TILE - 1) / TILE, grid_y),
        ],
        dim=-1,
    )
    if max_tiles_per_gaussian is not None:
        side = max(1, int(max_tiles_per_gaussian ** 0.5))
        ctr = torch.stack(
            [
                _tile_index(mean2d[:, 0] / TILE, grid_x - 1),
                _tile_index(mean2d[:, 1] / TILE, grid_y - 1),
            ],
            dim=-1,
        )
        half = side // 2
        rect_min = torch.maximum(rect_min, ctr - half)
        rect_max = torch.minimum(rect_max, ctr + (side - half))
        rect_max = torch.maximum(rect_max, rect_min)

    rect_wh = rect_max - rect_min
    tiles_touched = rect_wh[:, 0] * rect_wh[:, 1]

    valid = in_front & det_valid & (tiles_touched > 0)
    if alive is not None:
        valid = valid & alive

    if colors_precomp is None:
        sh = shs if isinstance(shs, ShInputs) else inputs_from_table(shs, sh_degree)
        with span("sh"):
            rgb = sh_color(means3d, cam_center, *sh)
    else:
        rgb = colors_precomp

    zero = torch.zeros((), dtype=means3d.dtype, device=means3d.device)
    return GaussianScreenData(
        mean2d=mean2d,
        depth=torch.where(valid, depth, zero),
        conic=conic,
        radius=torch.where(valid, radius, zero),
        rgb=rgb,
        opacity=opacities.reshape(n),
        valid=valid,
        rect_min=rect_min,
        rect_max=rect_max,
        tiles_touched=torch.where(valid, tiles_touched, 0).to(torch.int32),
    )


def clip_screen_to_rows(screen: GaussianScreenData, tile_row_start: int, num_tile_rows: int) -> GaussianScreenData:
    """Restrict preprocessed Gaussians to the band of tile rows
    [tile_row_start, tile_row_start + num_tile_rows) (parallel/tiles.py):
    mean2d.y moves into the band's pixel frame, the y extent of the tile
    rect is clipped to [0, num_tile_rows], and a Gaussian whose rect
    misses the band becomes invalid (tiles_touched 0, radius 0)."""
    y_off = float(tile_row_start * TILE)
    mean2d = screen.mean2d - torch.tensor([0.0, y_off], dtype=screen.mean2d.dtype, device=screen.mean2d.device)
    rmin_y = torch.clamp(screen.rect_min[:, 1] - tile_row_start, 0, num_tile_rows)
    rmax_y = torch.clamp(screen.rect_max[:, 1] - tile_row_start, 0, num_tile_rows)
    rect_min = torch.stack([screen.rect_min[:, 0], rmin_y], dim=-1)
    rect_max = torch.stack([screen.rect_max[:, 0], rmax_y], dim=-1)
    wh = rect_max - rect_min
    tiles = wh[:, 0] * wh[:, 1]
    valid = screen.valid & (tiles > 0)
    return screen._replace(
        mean2d=mean2d,
        rect_min=rect_min,
        rect_max=rect_max,
        tiles_touched=torch.where(valid, tiles, 0).to(torch.int32),
        valid=valid,
        radius=torch.where(valid, screen.radius, torch.zeros((), dtype=screen.radius.dtype, device=screen.radius.device)),
    )
