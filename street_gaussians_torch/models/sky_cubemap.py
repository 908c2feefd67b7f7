"""Sky cubemap: bilinear cube sampling through a double-window table.

Port of street_gaussians_tpu/models/sky_cubemap.py. The 4-tap lookup is
an autograd Function whose cubemap gradient needs no scatter: one entry
per pixel keyed by its base texel carries the 12 weighted cotangents,
a stable sort and a segmented row-sum (ops/segsum.py) give per-texel
sums, and three shifted tap planes add up. Face layout follows
nvdiffrast's OpenGL convention:
  face 0 +x: dir = ( 1, -v, -u)      face 1 -x: dir = (-1, -v,  u)
  face 2 +y: dir = ( u,  1,  v)      face 3 -y: dir = ( u, -1, -v)
  face 4 +z: dir = ( u, -v,  1)      face 5 -z: dir = (-u, -v, -1)
with u, v in [-1, 1] across the face; edges clamp to the face.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from street_gaussians_torch._device import resolve_device
from street_gaussians_torch.ops.segsum import segment_rowsum
from street_gaussians_torch.utils.camera import Camera, camera_rays
from street_gaussians_torch.utils.losses import jnp_clip
from street_gaussians_torch.utils.trace import span as trace_span

# texels per window-table row
WINDOW = 16


@dataclasses.dataclass
class SkyParams:
    """cubemap: [3, 6*R*R] channel-major texels (channel, face-major
    linear texel index)."""

    cubemap: torch.Tensor


def sky_resolution(cubemap: torch.Tensor) -> int:
    """Face resolution R of a [3, 6*R*R] cubemap."""
    return math.isqrt(cubemap.shape[1] // 6)


def init_sky(resolution: int = 1024, white_background: bool = True, device=None) -> SkyParams:
    """White-ε or ε init."""
    device = resolve_device(device)
    eps = 1e-3
    base = 1.0 - eps if white_background else eps
    return SkyParams(
        cubemap=torch.full((3, 6 * resolution * resolution), base, dtype=torch.float32, device=device)
    )


def _window_table(cm3: torch.Tensor, R: int) -> torch.Tensor:
    """[3, T] channel-major texels -> [ceil(T/W), 3*(2W+2)] double-window
    row table with channel-planar lanes: row r packs texels [Wr, Wr+W]
    and [Wr+R, Wr+R+W] per channel, lane c*(2W+2) + window*(W+1) + k,
    so one row serves all 4 bilinear taps of a pixel whose base texel
    falls in [Wr, Wr+W)."""
    T = cm3.shape[1]
    W = WINDOW
    nrows = -(-T // W)
    pieces = []
    for c in range(3):
        pc = torch.nn.functional.pad(cm3[c], (0, nrows * W + R + 2 * W + 1 - T))
        w0 = pc[: nrows * W].reshape(nrows, W)
        w0b = pc[W : W + nrows * W].reshape(nrows, W)[:, :1]
        w1 = pc[R : R + nrows * W].reshape(nrows, W)
        w1b = pc[R + W : R + W + nrows * W].reshape(nrows, W)[:, :1]
        pieces += [w0, w0b, w1, w1b]
    return torch.cat(pieces, dim=1)


def _combine_taps(tbl: torch.Tensor, base: torch.Tensor, e4: torch.Tensor) -> torch.Tensor:
    """Gather window rows by base // WINDOW, weight each tap's lane by
    its tap weight, and collapse the lanes to rgb with a 0/1 [lanes, 3]
    product (f32, no TF32)."""
    W = WINDOW
    span = 2 * W + 2  # lanes per channel
    dev = tbl.device
    bflat = base.reshape(-1)
    rows = tbl[bflat // W]  # [P, 3*span]
    j = (bflat % W)[:, None]
    ef = e4.reshape(-1, 4)
    lane = np.arange(3 * span)
    with trace_span("sync/sky_constants"):  # numpy lane tables copied to the card
        kvec = torch.as_tensor((lane % span) % (W + 1), device=dev)[None, :]
        lo = torch.as_tensor((lane % span) < W + 1, device=dev)[None, :]
    w_hit = torch.where(lo, ef[:, 0:1], ef[:, 2:3])
    w_nxt = torch.where(lo, ef[:, 1:2], ef[:, 3:4])
    zero = torch.zeros((), dtype=ef.dtype, device=dev)
    Wimg = torch.where(kvec == j, w_hit, zero) + torch.where(kvec == j + 1, w_nxt, zero)
    with trace_span("sync/sky_constants"):
        collapse = torch.as_tensor(
            (lane[:, None] // span) == np.arange(3)[None, :], dtype=torch.float32, device=dev
        )
    out = (rows * Wimg) @ collapse  # [P, 3]
    return out.reshape(*base.shape, 3)


def bilinear_taps_grad(
    d_out: torch.Tensor, base: torch.Tensor, e4: torch.Tensor, T: int, R: int
) -> torch.Tensor:
    """Cubemap gradient [3, T] of the 4-tap lookup (the JAX package's
    _bt_bwd), without a scatter: sort one entry per pixel by its base
    texel (stable, so the sum order is fixed), carrying the 12 channels
    e_t * d_rgb (row 3t + r: tap t, channel r); sum each texel's rows
    with segment_rowsum; then add the +1, +R and +R+1 tap planes shifted
    to their texels. Live taps never cross a row or face edge (border
    folding gives such taps weight 0)."""
    C = d_out.shape[-1]
    ef = e4.reshape(-1, 4)
    chans = (ef[:, :, None] * d_out.reshape(-1, C)[:, None, :]).reshape(-1, 4 * C).t()
    skeys, order = torch.sort(base.reshape(-1).to(torch.int32), stable=True)
    planes = segment_rowsum(chans[:, order], skeys, num_segments=T, skip_empty=True)
    d_cm = planes[0:C].clone()
    for t, off in enumerate((1, R, R + 1)):
        d_cm[:, off:] += planes[(t + 1) * C : (t + 2) * C, : T - off]
    return d_cm


class BilinearTaps(torch.autograd.Function):
    """The 4-tap lookup of a [3, T] cubemap with bilinear_taps_grad as
    its gradient. Rays come from the camera and the jitter, neither
    learnable, so the tap weights and base texels get none."""

    @staticmethod
    def forward(ctx, cm3, base, e4, R):
        ctx.save_for_backward(base, e4)
        ctx.dims = (cm3.shape[1], R)
        return _combine_taps(_window_table(cm3, R), base, e4)

    @staticmethod
    def backward(ctx, d_out):
        base, e4 = ctx.saved_tensors
        with trace_span("sky_bwd"):
            return bilinear_taps_grad(d_out, base, e4, *ctx.dims), None, None, None


def build_sky_table(cubemap: torch.Tensor) -> torch.Tensor:
    """The serving-time window table for `sample_cubemap(table=...)`.
    Depends only on the cubemap: build once, sample every frame."""
    return _window_table(cubemap, sky_resolution(cubemap))


def sample_cubemap(
    cubemap: torch.Tensor, dirs: torch.Tensor, table: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Bilinear cube sampling. dirs [..., 3] (need not be normalized);
    returns [..., 3]. `table`: optional precomputed build_sky_table, for
    serving only (not differentiable in the cubemap); without it the
    window table is built from the live cubemap."""
    R = sky_resolution(cubemap)
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    ax, ay, az = torch.abs(x), torch.abs(y), torch.abs(z)

    is_x = (ax >= ay) & (ax >= az)
    is_y = (~is_x) & (ay >= az)
    face = torch.where(
        is_x,
        torch.where(x > 0, 0, 1),
        torch.where(is_y, torch.where(y > 0, 2, 3), torch.where(z > 0, 4, 5)),
    )

    major = torch.where(is_x, ax, torch.where(is_y, ay, az))
    major = torch.clamp(major, min=1e-12)
    u = torch.where(
        is_x,
        torch.where(x > 0, -z, z),
        torch.where(is_y, x, torch.where(z > 0, x, -x)),
    ) / major
    v = torch.where(is_x, -y, torch.where(is_y, torch.where(y > 0, z, -z), -y)) / major

    # texel grid: u = -1 + (2i+1)/R at texel centers
    px = (u + 1.0) * 0.5 * R - 0.5
    py = (v + 1.0) * 0.5 * R - 0.5
    x0 = torch.floor(px)
    y0 = torch.floor(py)
    fx = px - x0
    fy = py - y0
    x0i = torch.clamp(x0.to(torch.int64), 0, R - 1)
    x1i = torch.clamp(x0i + 1, 0, R - 1)
    y0i = torch.clamp(y0.to(torch.int64), 0, R - 1)
    y1i = torch.clamp(y0i + 1, 0, R - 1)

    # taps as (base texel, offsets {0, 1, R, R+1}); at clamped borders
    # the degenerate tap's weight folds into its live partner
    base = face * (R * R) + y0i * R + x0i
    w00 = (1 - fx) * (1 - fy)
    w01 = fx * (1 - fy)
    w10 = (1 - fx) * fy
    w11 = fx * fy
    degx = (x1i == x0i).to(w00.dtype)
    degy = (y1i == y0i).to(w00.dtype)
    e00 = w00 + degx * w01 + degy * w10 + degx * degy * w11
    e01 = (1 - degx) * (w01 + degy * w11)
    e10 = (1 - degy) * (w10 + degx * w11)
    e11 = (1 - degx) * (1 - degy) * w11
    e4 = torch.stack([e00, e01, e10, e11], dim=-1)
    if table is not None:
        return _combine_taps(table, base, e4)
    return BilinearTaps.apply(cubemap, base, e4, R)


def render_sky(
    params: SkyParams,
    cam: Camera,
    downsample: int = 1,
    table: Optional[torch.Tensor] = None,
    jitter: Optional[torch.Tensor] = None,
    row_start: int = 0,
    num_rows: Optional[int] = None,
) -> torch.Tensor:
    """Per-pixel sky color [H, W, 3], clamped to [0, 1] (jnp.clip's
    gradient: half at a tie); with downsample > 1 the small
    [ceil(H/N), ceil(W/N), 3] image that the caller upsamples.
    jitter: optional [H, W, 2] train-time sub-pixel ray offsets.
    row_start / num_rows: a tile-row band's image rows (camera_rays);
    H is then num_rows."""
    dirs = camera_rays(cam, downsample=downsample, jitter=jitter, row_start=row_start, num_rows=num_rows)
    return jnp_clip(sample_cubemap(params.cubemap, dirs, table=table), 0.0, 1.0)
