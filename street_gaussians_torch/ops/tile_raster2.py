"""Instance-major tile blend, forward (kernel B).

Replaces street_gaussians_tpu/ops/tile_raster2.py::_fwd_kernel with
`csrc/tile_blend.cu`. Each 16x16 tile owns a ragged run
[tile_start, tile_start + tile_count) of the (tile, depth)-sorted
instance array (ops/binning.bin_gaussians_instances); instance i lives
at payload[i // 128, :, i % 128].

Payload block layout: [num_blocks + 1, c_pad, 128]; c_pad rows:
  0 mean_x, 1 mean_y, 2 conic_a, 3 conic_b, 4 conic_c, 5 opacity,
  6..6+F features, 6+F..6+F+2 AbsGS gradient rows (zero; backward only).
Output: [num_tiles, 256, F + 1], the F blended features then final T.

Bound on the H100: the per-pixel exp/log1p and FMA work, far above the
payload bytes. The kernel runs one block of 256 threads per tile (one
thread per pixel), stages each 128-lane payload block of the run in
shared memory and leaves once every pixel of the tile has stopped. It
needs none of the TPU kernel's flattened step tables
(`_flatten_steps`): the grid is simply one block per tile. The
transmittance is carried in log space with the JAX kernel's
termination test (see `csrc/tile_blend.cu`).

`tile_blend_instances` runs the plain PyTorch version for a CPU tensor
and the kernel for a CUDA tensor. Forward only: the backward kernel
belongs to the training slice.
"""

from __future__ import annotations

import ctypes
import math

import torch

from street_gaussians_torch.kernels import _build

TILE = 16
PIX = TILE * TILE  # 256 pixels per tile
CHUNK = 128  # instances per payload block
ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
T_EPS = 1e-4
LOG_T_EPS = math.log(T_EPS)
PAYLOAD_HEADER = 6  # rows before the feature rows
ABS_ROWS = 2  # AbsGS gradient rows (zero in the forward)
MAX_FEATURES = 8  # feature counts the CUDA kernel is instantiated for
# tiles per step of the plain version (bounds its [tiles, 256, 128]
# temporaries to about 1 GB each at the largest)
_PLAIN_TILES = 2048


def payload_rows(num_features: int) -> int:
    """Total payload rows (incl. the 2 AbsGS rows), padded up to a
    multiple of 8, as street_gaussians_tpu/ops/tile_raster.py."""
    c = PAYLOAD_HEADER + num_features + ABS_ROWS
    return ((c + 7) // 8) * 8


def _bind(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.tile_blend_fwd.argtypes = [p, p, p, p, i, i, i, i, p]
    lib.tile_blend_fwd.restype = ctypes.c_int


def _pixel_coords(tiles: torch.Tensor, grid_x: int):
    """Integer pixel coordinates [n, 256] of the given tiles."""
    p = torch.arange(PIX, device=tiles.device)
    px = (tiles[:, None] % grid_x) * TILE + p[None, :] % TILE
    py = (tiles[:, None] // grid_x) * TILE + p[None, :] // TILE
    return px.to(torch.float32), py.to(torch.float32)


def tile_blend_plain(
    payload: torch.Tensor,
    tile_start: torch.Tensor,
    tile_count: torch.Tensor,
    num_features: int,
    grid_x: int,
    num_tiles: int,
    return_work: bool = False,
):
    """Plain PyTorch version: vectorised over tiles, sequential over the
    128-lane block index of each run, in the JAX kernel's log-space
    prefix-sum form (tile_raster2._block_alpha / _blend_masks_log).

    return_work: also return {"evaluated": pairs, "blended": pairs}, the
    (pixel, instance) pairs a blend that stops per pixel must evaluate
    (up to and including each pixel's stopping instance) and those it
    blends."""
    F = num_features
    dev = payload.device
    start = tile_start.to(torch.int64)
    cnt = tile_count.to(torch.int64)
    nblocks = torch.where(cnt > 0, (start % CHUNK + cnt + CHUNK - 1) // CHUNK, 0)
    b0 = start // CHUNK
    out = torch.empty((num_tiles, PIX, F + 1), dtype=torch.float32, device=dev)
    lane = torch.arange(CHUNK, device=dev)
    work = {k: torch.zeros((), dtype=torch.int64, device=dev) for k in ("evaluated", "blended")}
    for t0 in range(0, num_tiles, _PLAIN_TILES):
        tiles = torch.arange(t0, min(t0 + _PLAIN_TILES, num_tiles), device=dev)
        n = tiles.numel()
        px, py = _pixel_coords(tiles, grid_x)
        logT = torch.zeros((n, PIX), dtype=torch.float32, device=dev)
        done = torch.zeros((n, PIX), dtype=torch.bool, device=dev)
        accum = torch.zeros((n, PIX, F), dtype=torch.float32, device=dev)
        nb = nblocks[tiles]
        for i in range(int(nb.max()) if n else 0):
            # tiles with a block i and a pixel still blending
            act = ((i < nb) & ~done.all(dim=1)).nonzero().squeeze(1)
            if act.numel() == 0:
                break
            tg = tiles[act]
            blk = payload[b0[tg] + i]  # [m, c_pad, 128]
            glob = (b0[tg] + i)[:, None] * CHUNK + lane[None, :]
            slot_valid = (glob >= start[tg, None]) & (glob < (start + cnt)[tg, None])
            hdr = blk[:, :PAYLOAD_HEADER, None, :]  # [m, 6, 1, 128]
            mx, my, ca, cb, cc, op = hdr.unbind(1)
            dx = mx - px[act][:, :, None]  # [m, 256, 128]
            dy = my - py[act][:, :, None]
            power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
            alpha = torch.clamp(op * torch.exp(torch.clamp(power, max=0.0)), max=ALPHA_MAX)
            d_act = done[act]
            active = (
                (power <= 0.0) & (alpha >= ALPHA_MIN)
                & ~d_act[:, :, None] & slot_valid[:, None, :]
            )
            a = torch.where(active, alpha, 0.0)
            logs = torch.log1p(-a)
            cums = torch.cumsum(logs, dim=2)
            lT = logT[act][:, :, None]
            not_term = lT + cums >= LOG_T_EPS
            blend = (a > 0.0) & not_term
            trigger = (a > 0.0) & ~not_term
            w = torch.where(blend, a * torch.exp(lT + cums - logs), 0.0)
            feat = blk[:, PAYLOAD_HEADER:PAYLOAD_HEADER + F, :]  # [m, F, 128]
            accum[act] += torch.einsum("mpl,mfl->mpf", w, feat)
            logT[act] += torch.where(blend, logs, 0.0).sum(dim=2)
            done[act] |= trigger.any(dim=2)
            if return_work:
                # lanes up to and including the stopping one: those
                # whose exclusive prefix had not yet terminated
                reached = lT + (cums - logs) >= LOG_T_EPS
                work["evaluated"] += (slot_valid[:, None, :] & ~d_act[:, :, None] & reached).sum()
                work["blended"] += blend.sum()
        out[tiles, :, :F] = accum
        out[tiles, :, F] = torch.exp(logT)
    return (out, work) if return_work else out


def _check_args(payload, tile_start, tile_count, num_features, num_tiles):
    if payload.dim() != 3 or payload.shape[2] != CHUNK or payload.dtype != torch.float32:
        raise ValueError(f"tile_blend_instances: payload must be [NB+1, c_pad, {CHUNK}] float32")
    if payload.shape[1] < PAYLOAD_HEADER + num_features:
        raise ValueError("tile_blend_instances: payload has fewer rows than 6 + F")
    for name, t in (("tile_start", tile_start), ("tile_count", tile_count)):
        if t.shape != (num_tiles,) or t.dtype != torch.int32:
            raise ValueError(f"tile_blend_instances: {name} must be [{num_tiles}] int32")
        if t.device != payload.device:
            raise ValueError(f"tile_blend_instances: {name} is not on the payload's device")


def tile_blend_instances(
    payload: torch.Tensor,
    tile_start: torch.Tensor,
    tile_count: torch.Tensor,
    num_features: int,
    grid_x: int,
    num_tiles: int,
) -> torch.Tensor:
    """Alpha-blend instance-major payload blocks (ragged tile runs).
    Returns [num_tiles, 256, F+1]."""
    _check_args(payload, tile_start, tile_count, num_features, num_tiles)
    if payload.device.type == "cpu":
        return tile_blend_plain(
            payload, tile_start, tile_count, num_features, grid_x, num_tiles
        )
    _build.require_cuda(payload, "tile_blend_instances")
    if not 1 <= num_features <= MAX_FEATURES:
        raise ValueError(
            f"tile_blend_instances: the kernel takes 1..{MAX_FEATURES} features, got {num_features}"
        )
    payload = payload.contiguous()
    tile_start = tile_start.contiguous()
    tile_count = tile_count.contiguous()
    out = torch.empty(
        (num_tiles, PIX, num_features + 1), dtype=torch.float32, device=payload.device
    )
    lib = _build.load("tile_blend", _bind)
    err = lib.tile_blend_fwd(
        _build.ptr(payload), _build.ptr(tile_start), _build.ptr(tile_count),
        _build.ptr(out), num_tiles, grid_x, payload.shape[1], num_features,
        _build.stream_of(payload),
    )
    _build.check(err, "tile_blend_instances")
    tile_blend_instances.launches += 1
    return out


tile_blend_instances.launches = 0
