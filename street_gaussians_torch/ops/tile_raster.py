"""Dense-table tile blend: forward and backward.

Replaces street_gaussians_tpu/ops/tile_raster.py::_fwd_kernel with
`csrc/tile_blend_table.cu` and its `_bwd_kernel` with
`csrc/tile_blend_table_bwd.cu`. Tile t owns payload[t], a [c_pad, K]
table of its depth-ordered Gaussians (ops/binning.bin_gaussians); the
rows are those of ops/tile_raster2.py, and opacity 0 marks an empty
slot. `tile_count[t]` only sets how many 128-lane chunks of the table
are read, cdiv(count, 128): the blend never masks a lane by the count
and relies on the empty slots' zero opacity.

Unlike the instance-major blend, the transmittance is carried as a
direct product: within a chunk cp is the running product of (1 - alpha),
a pixel stops at the first Gaussian with T * cp * (1 - alpha) < 1e-4
(not blended), and T is multiplied by the product over the Gaussians
that blended. A chunk is skipped once every pixel of the tile has
stopped; its lanes keep gradient 0.

Output: [num_tiles, 256, F + 1], the F blended features then final T.
The payload's gradient, [num_tiles, c_pad, K], holds per slot d mean
x/y, d conic a/b/c, d opacity, d features and the two AbsGS rows
(per-pixel |d mean2d| sums).

Bound on the H100: as the instance-major blend, the per-pixel exp and
FMA work, far above the bytes of the live chunks. Both kernels run one
block of 256 threads per tile (one thread per pixel) and stage each
128-lane chunk in shared memory; no block shares a slot with another,
so the backward writes its own table without atomics.

F = 1..8 is instantiated; F = 9..64 (tile_raster2.MAX_FEATURES) takes
the kernels' runtime-count variants, the chunk's rows and the
per-feature state in shared memory; a wider F raises.

`tile_blend` and `tile_blend_bwd` run their plain PyTorch versions for a
CPU tensor and their kernels for a CUDA tensor. `TileBlend` is the
autograd Function around the two.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from street_gaussians_torch.kernels import _build
from street_gaussians_torch.ops.tile_raster2 import (
    _PLAIN_TILES,
    ABS_ROWS,
    ALPHA_MAX,
    ALPHA_MIN,
    CHUNK,
    MAX_FEATURES,
    PAYLOAD_HEADER,
    PIX,
    T_EPS,
    _pixel_coords,
    payload_rows,
)


class _Chunk(NamedTuple):
    """One 128-lane chunk of each active tile's table, per (tile, pixel,
    lane): what both plain versions compute from it."""

    blk: torch.Tensor  # [m, c_pad, 128]
    dx: torch.Tensor  # [m, 256, 128]
    dy: torch.Tensor
    conic: tuple  # (ca, cb, cc), each [m, 1, 128]
    apow: torch.Tensor  # exp(min(power, 0))
    alpha_raw: torch.Tensor  # op * apow
    a: torch.Tensor  # clamped alpha where active, else 0
    cp_excl: torch.Tensor  # in-chunk exclusive prefix product of 1 - a
    T: torch.Tensor  # [m, 256, 1] transmittance before the chunk
    blend: torch.Tensor  # bool: blended
    trigger: torch.Tensor  # bool: would stop its pixel, not blended
    survived: torch.Tensor  # [m, 256] product of 1 - a over the blended lanes


def _plain_chunk(payload, tiles, i, px, py, done, T) -> _Chunk:
    """Chunk i of the tables of `tiles`, in the JAX kernel's product form
    (tile_raster._chunk_alpha / _blend_masks / _survived_product)."""
    blk = payload[tiles, :, i * CHUNK:(i + 1) * CHUNK]  # [m, c_pad, 128]
    mx, my, ca, cb, cc, op = blk[:, :PAYLOAD_HEADER, None, :].unbind(1)  # [m, 1, 128] each
    dx = mx - px[:, :, None]  # [m, 256, 128]
    dy = my - py[:, :, None]
    power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
    apow = torch.exp(torch.clamp(power, max=0.0))
    alpha_raw = op * apow
    alpha = torch.clamp(alpha_raw, max=ALPHA_MAX)
    active = (power <= 0.0) & (alpha >= ALPHA_MIN) & ~done[:, :, None]
    a = torch.where(active, alpha, 0.0)
    cp_incl = torch.cumprod(1.0 - a, dim=2)
    cp_excl = torch.cat([torch.ones_like(cp_incl[:, :, :1]), cp_incl[:, :, :-1]], dim=2)
    Tc = T[:, :, None]
    trigger = (a > 0.0) & (Tc * cp_incl < T_EPS)
    blend = (a > 0.0) & (torch.cumsum(trigger, dim=2) == 0)
    # cp_excl at the first trigger (the largest over the trigger lanes:
    # the prefix never grows), else the whole chunk's product
    best = torch.where(trigger, cp_excl, 0.0).amax(dim=2)
    survived = torch.where(trigger.any(dim=2), best, cp_incl[:, :, -1])
    return _Chunk(blk, dx, dy, (ca, cb, cc), apow, alpha_raw, a, cp_excl, Tc, blend, trigger, survived)


def _num_chunks(tile_count: torch.Tensor, capacity: int) -> torch.Tensor:
    n = (tile_count.to(torch.int64) + CHUNK - 1) // CHUNK
    return torch.clamp(n, min=0, max=capacity // CHUNK)


def tile_blend_plain(
    payload: torch.Tensor,
    tile_count: torch.Tensor,
    num_features: int,
    grid_x: int,
    return_work: bool = False,
):
    """Plain PyTorch version: vectorised over tiles, sequential over the
    128-lane chunks of the table.

    return_work: also return {"evaluated": pairs, "blended": pairs,
    "chunks": n}: the (pixel, slot) pairs below the tile's count that a
    blend that stops per pixel must evaluate (up to and including each
    pixel's stopping Gaussian), those it blends, and the chunks read."""
    F = num_features
    dev = payload.device
    num_tiles, _, K = payload.shape
    nchunks = _num_chunks(tile_count, K)
    out = torch.empty((num_tiles, PIX, F + 1), dtype=torch.float32, device=dev)
    work = {k: torch.zeros((), dtype=torch.int64, device=dev) for k in ("evaluated", "blended", "chunks")}
    lane = torch.arange(CHUNK, device=dev)
    for t0 in range(0, num_tiles, _PLAIN_TILES):
        tiles = torch.arange(t0, min(t0 + _PLAIN_TILES, num_tiles), device=dev)
        n = tiles.numel()
        px, py = _pixel_coords(tiles, grid_x)
        T = torch.ones((n, PIX), dtype=torch.float32, device=dev)
        done = torch.zeros((n, PIX), dtype=torch.bool, device=dev)
        accum = torch.zeros((n, PIX, F), dtype=torch.float32, device=dev)
        nc = nchunks[tiles]
        for i in range(int(nc.max()) if n else 0):
            # tiles with a chunk i and a pixel still blending
            act = ((i < nc) & ~done.all(dim=1)).nonzero().squeeze(1)
            if act.numel() == 0:
                break
            k = _plain_chunk(payload, tiles[act], i, px[act], py[act], done[act], T[act])
            w = torch.where(k.blend, k.a * k.T * k.cp_excl, 0.0)
            feat = k.blk[:, PAYLOAD_HEADER:PAYLOAD_HEADER + F, :]  # [m, F, 128]
            if return_work:
                live = (i * CHUNK + lane)[None, :] < tile_count[tiles[act], None]
                # lanes up to and including the stopping one
                reached = (torch.cumsum(k.trigger, dim=2) - k.trigger.to(torch.int64)) == 0
                work["evaluated"] += (live[:, None, :] & ~done[act][:, :, None] & reached).sum()
                work["blended"] += k.blend.sum()
                work["chunks"] += act.numel()
            accum[act] += torch.einsum("mpl,mfl->mpf", w, feat)
            T[act] *= k.survived
            done[act] |= k.trigger.any(dim=2)
        out[tiles, :, :F] = accum
        out[tiles, :, F] = T
    return (out, work) if return_work else out


def tile_blend_bwd_plain(
    payload: torch.Tensor,
    tile_count: torch.Tensor,
    out: torch.Tensor,
    gout: torch.Tensor,
    num_features: int,
    grid_x: int,
) -> torch.Tensor:
    """Plain PyTorch version of the backward, in the JAX kernel's form
    (forward order, the suffix as S_total minus the prefix of u).
    Returns d_payload, the shape of payload, zero in the chunks the
    forward did not read."""
    F = num_features
    dev = payload.device
    num_tiles, _, K = payload.shape
    nchunks = _num_chunks(tile_count, K)
    NG = PAYLOAD_HEADER + F + ABS_ROWS
    d_payload = torch.zeros_like(payload)
    for t0 in range(0, num_tiles, _PLAIN_TILES):
        tiles = torch.arange(t0, min(t0 + _PLAIN_TILES, num_tiles), device=dev)
        n = tiles.numel()
        px, py = _pixel_coords(tiles, grid_x)
        g = gout[tiles, :, :F]  # [n, 256, F]
        s_total = (g * out[tiles, :, :F]).sum(dim=2)
        gt_tfin = gout[tiles, :, F] * out[tiles, :, F]
        T = torch.ones((n, PIX), dtype=torch.float32, device=dev)
        u_prev = torch.zeros((n, PIX), dtype=torch.float32, device=dev)
        done = torch.zeros((n, PIX), dtype=torch.bool, device=dev)
        nc = nchunks[tiles]
        for i in range(int(nc.max()) if n else 0):
            act = ((i < nc) & ~done.all(dim=1)).nonzero().squeeze(1)
            if act.numel() == 0:
                break
            k = _plain_chunk(payload, tiles[act], i, px[act], py[act], done[act], T[act])
            dx, dy, (ca, cb, cc), a = k.dx, k.dy, k.conic, k.a
            tprefix = k.T * k.cp_excl
            w = torch.where(k.blend, a * tprefix, 0.0)
            feat = k.blk[:, PAYLOAD_HEADER:PAYLOAD_HEADER + F, :]  # [m, F, 128]
            ga = g[act]
            phi = torch.einsum("mpf,mfl->mpl", ga, feat)
            u = w * phi
            suffix = s_total[act][:, :, None] - (torch.cumsum(u, dim=2) + u_prev[act][:, :, None])
            da = torch.where(
                k.blend, tprefix * phi - (suffix + gt_tfin[act][:, :, None]) / (1.0 - a), 0.0
            )
            da_eff = torch.where(k.alpha_raw <= ALPHA_MAX, da, 0.0)
            dpow = k.alpha_raw * da_eff
            gmx = ca * dx + cb * dy
            gmy = cc * dy + cb * dx
            new_rows = torch.cat(
                [
                    torch.stack(
                        [
                            (-gmx * dpow).sum(dim=1),
                            (-gmy * dpow).sum(dim=1),
                            (-0.5 * dx * dx * dpow).sum(dim=1),
                            (-dx * dy * dpow).sum(dim=1),
                            (-0.5 * dy * dy * dpow).sum(dim=1),
                            (k.apow * da_eff).sum(dim=1),
                        ],
                        dim=1,
                    ),
                    torch.einsum("mpf,mpl->mfl", ga, w),
                    torch.stack(
                        [(gmx * dpow).abs().sum(dim=1), (gmy * dpow).abs().sum(dim=1)], dim=1
                    ),
                ],
                dim=1,
            )  # [m, 8 + F, 128]
            d_payload[tiles[act], :NG, i * CHUNK:(i + 1) * CHUNK] = new_rows
            T[act] *= k.survived
            u_prev[act] += u.sum(dim=2)
            done[act] |= k.trigger.any(dim=2)
    return d_payload


def _check_args(name, payload, tile_count, num_features):
    if not 1 <= num_features <= MAX_FEATURES:
        raise ValueError(f"{name}: the kernels take 1..{MAX_FEATURES} features (MAX_FEATURES), got {num_features}")
    if payload.dim() != 3 or payload.dtype != torch.float32:
        raise ValueError(f"{name}: payload must be [num_tiles, c_pad, K] float32")
    if payload.shape[2] % CHUNK != 0:
        raise ValueError(f"{name}: the table's capacity {payload.shape[2]} is not a multiple of {CHUNK}")
    if payload.shape[1] < PAYLOAD_HEADER + num_features:
        raise ValueError(f"{name}: payload has fewer rows than 6 + F")
    if tile_count.shape != (payload.shape[0],) or tile_count.dtype != torch.int32:
        raise ValueError(f"{name}: tile_count must be [{payload.shape[0]}] int32")
    if tile_count.device != payload.device:
        raise ValueError(f"{name}: tile_count is not on the payload's device")


def _bind(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.tile_blend_table_fwd.argtypes = [p, p, p, i, i, i, i, i, p]
    lib.tile_blend_table_fwd.restype = ctypes.c_int


def tile_blend(
    payload: torch.Tensor, tile_count: torch.Tensor, num_features: int, grid_x: int
) -> torch.Tensor:
    """Alpha-blend each tile's table. payload [num_tiles, c_pad, K],
    tile_count [num_tiles] int32. Returns [num_tiles, 256, F+1]."""
    _check_args("tile_blend", payload, tile_count, num_features)
    if payload.device.type == "cpu":
        return tile_blend_plain(payload, tile_count, num_features, grid_x)
    _build.require_cuda(payload, "tile_blend")
    payload = payload.contiguous()
    tile_count = tile_count.contiguous()
    num_tiles, c_pad, K = payload.shape
    out = torch.empty((num_tiles, PIX, num_features + 1), dtype=torch.float32, device=payload.device)
    lib = _build.load("tile_blend_table", _bind)
    err = lib.tile_blend_table_fwd(
        _build.ptr(payload), _build.ptr(tile_count), _build.ptr(out),
        num_tiles, grid_x, c_pad, K, num_features, _build.stream_of(payload),
    )
    _build.check(err, "tile_blend")
    tile_blend.launches += 1
    return out


tile_blend.launches = 0


def _bind_bwd(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.tile_blend_table_bwd.argtypes = [p, p, p, p, p, i, i, i, i, i, p]
    lib.tile_blend_table_bwd.restype = ctypes.c_int


def tile_blend_bwd(
    payload: torch.Tensor,
    tile_count: torch.Tensor,
    out: torch.Tensor,
    gout: torch.Tensor,
    num_features: int,
    grid_x: int,
) -> torch.Tensor:
    """Gradient of tile_blend's payload given its output `out` and the
    output's cotangent `gout` (both [num_tiles, 256, F+1])."""
    _check_args("tile_blend_bwd", payload, tile_count, num_features)
    shape = (payload.shape[0], PIX, num_features + 1)
    for name, t in (("out", out), ("gout", gout)):
        if tuple(t.shape) != shape or t.dtype != torch.float32 or t.device != payload.device:
            raise ValueError(f"tile_blend_bwd: {name} must be {list(shape)} float32 on the payload's device")
    if payload.shape[1] < payload_rows(num_features):
        raise ValueError("tile_blend_bwd: payload has fewer rows than payload_rows(F)")
    if payload.device.type == "cpu":
        return tile_blend_bwd_plain(payload, tile_count, out, gout, num_features, grid_x)
    _build.require_cuda(payload, "tile_blend_bwd")
    payload, tile_count, out, gout = (t.contiguous() for t in (payload, tile_count, out, gout))
    num_tiles, c_pad, K = payload.shape
    d_payload = torch.zeros_like(payload)
    lib = _build.load("tile_blend_table_bwd", _bind_bwd)
    err = lib.tile_blend_table_bwd(
        _build.ptr(payload), _build.ptr(tile_count), _build.ptr(out), _build.ptr(gout),
        _build.ptr(d_payload), num_tiles, grid_x, c_pad, K, num_features,
        _build.stream_of(payload),
    )
    _build.check(err, "tile_blend_bwd")
    tile_blend_bwd.launches += 1
    return d_payload


tile_blend_bwd.launches = 0


class TileBlend(torch.autograd.Function):
    """tile_blend with tile_blend_bwd as its gradient (the payload's
    only; the counts are integers)."""

    @staticmethod
    def forward(ctx, payload, tile_count, num_features, grid_x):
        out = tile_blend(payload, tile_count, num_features, grid_x)
        ctx.save_for_backward(payload, tile_count, out)
        ctx.dims = (num_features, grid_x)
        return out

    @staticmethod
    def backward(ctx, gout):
        payload, tile_count, out = ctx.saved_tensors
        d_payload = tile_blend_bwd(payload, tile_count, out, gout.contiguous(), *ctx.dims)
        return d_payload, None, None, None
