"""Instance-major tile blend: forward (kernel B) and backward.

Replaces street_gaussians_tpu/ops/tile_raster2.py::_fwd_kernel with
`csrc/tile_blend.cu` and its `_bwd_kernel` with `csrc/tile_blend_bwd.cu`.
Each 16x16 tile owns a ragged run [tile_start, tile_start + tile_count)
of the (tile, depth)-sorted instance array
(ops/binning.bin_gaussians_instances); instance i lives at
payload[i // 128, :, i % 128].

Payload block layout: [num_blocks + 1, c_pad, 128]; c_pad rows:
  0 mean_x, 1 mean_y, 2 conic_a, 3 conic_b, 4 conic_c, 5 opacity,
  6..6+F features, 6+F..6+F+2 AbsGS gradient rows (zero; backward only).
Output: [num_tiles, 256, F + 1], the F blended features then final T.

Bound on the H100: the per-pixel exp/log1p and arithmetic, far above the
payload bytes. What a kernel with one block per tile loses is neither: a
run is walked in order, and a street scene has a dozen tiles of 10,000
instances and more beside a median of 50, so such a launch lasts as long
as its longest tile. Both kernels therefore work through a list of
items built on the card (no count comes back to the host): a run that
touches more than SEG / 128 payload blocks is cut into segments of that
many blocks, each its own block of 256 threads (one per pixel), and the
log-space transmittance makes them independent. A first pass (one block
per 128-lane payload block of the long tiles) gives each segment's
per-pixel sum of log1p(-alpha); a pixel enters a segment with the sum of
the earlier segments' sums and had stopped before it exactly when that
is below log(1e-4); the segments' partial accumulators are
added in segment order. The sums and partials (`BlendState`) stay on the
card for the backward, whose segments need them as their entering state
(the prefix of u is g . the accumulator before the segment). It needs
none of the TPU kernel's flattened step tables (`_flatten_steps`). See
the notes at the head of the two sources for the rest of the design
(lanes evaluated in batches, the backward's lane-parallel 256-pixel
sums) and for why the segments agree bit for bit on where a pixel stops.

Features: F = 4 on the main path (rgb, depth), 7 with normals, 4 + S
with S semantic classes, 27 with both at 20 classes. The kernels are
instantiated for F = 1..8; F = 9..MAX_FEATURES (64) takes variants with
F a runtime count, whose per-feature state (the forward's accumulators,
the backward's cotangents and its reduction, 8 rows a pass) lives in
shared memory and whose sums run in the instantiated kernels' order.
A wider F raises.

`tile_blend_instances` (forward) and `tile_blend_bwd` (backward) run
their plain PyTorch versions for a CPU tensor and their kernels for a
CUDA tensor. `TileBlendInstances` is the autograd Function around the
two: the gradient of the payload, [NB+1, c_pad, 128], holds per
instance lane d mean x/y, d conic a/b/c, d opacity, d features and the
two AbsGS rows (per-pixel |d mean2d| sums) where the forward has zeros.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional

import torch

from street_gaussians_torch.kernels import _build

TILE = 16
PIX = TILE * TILE  # 256 pixels per tile
CHUNK = 128  # instances per payload block
# lanes per segment of a long run, a multiple of CHUNK: a run that
# touches more than SEG / CHUNK payload blocks is split (the kernels only)
SEG = 1024
ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
T_EPS = 1e-4
LOG_T_EPS = math.log(T_EPS)
PAYLOAD_HEADER = 6  # rows before the feature rows
ABS_ROWS = 2  # AbsGS gradient rows (zero in the forward)
# feature counts the CUDA kernels take: 1..8 instantiated, 9..64 through
# their runtime-count kernels (per-feature state in shared memory); a
# wider F raises, on the card and on the CPU alike
MAX_FEATURES = 64
# tiles per step of the plain version (bounds its [tiles, 256, 128]
# temporaries to about 1 GB each at the largest)
_PLAIN_TILES = 2048
# more nvcc flags for both kernels' libraries: script/block_times.py
# sets a probe build here for the length of its measurement
BUILD_FLAGS: tuple = ()


def payload_rows(num_features: int) -> int:
    """Total payload rows (incl. the 2 AbsGS rows), padded up to a
    multiple of 8, as street_gaussians_tpu/ops/tile_raster.py."""
    c = PAYLOAD_HEADER + num_features + ABS_ROWS
    return ((c + 7) // 8) * 8


def _bind(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.tile_blend_fwd.argtypes = [p] * 7 + [i] * 7 + [p]
    lib.tile_blend_fwd.restype = ctypes.c_int
    lib.tile_blend_plan.argtypes = [p, p, p, i, i, i, p]
    lib.tile_blend_plan.restype = ctypes.c_int


def _pixel_coords(tiles: torch.Tensor, grid_x: int):
    """Integer pixel coordinates [n, 256] of the given tiles."""
    p = torch.arange(PIX, device=tiles.device)
    px = (tiles[:, None] % grid_x) * TILE + p[None, :] % TILE
    py = (tiles[:, None] // grid_x) * TILE + p[None, :] // TILE
    return px.to(torch.float32), py.to(torch.float32)


class _Block(NamedTuple):
    """One 128-lane payload block of each active tile's run, per (tile,
    pixel, lane): what both plain versions compute from it."""

    bidx: torch.Tensor  # [m] payload block index
    blk: torch.Tensor  # [m, c_pad, 128]
    slot_valid: torch.Tensor  # [m, 128] lanes inside the tile's run
    dx: torch.Tensor  # [m, 256, 128]
    dy: torch.Tensor
    conic: tuple  # (ca, cb, cc), each [m, 1, 128]
    apow: torch.Tensor  # exp(min(power, 0))
    alpha_raw: torch.Tensor  # op * apow
    a: torch.Tensor  # clamped alpha where active, else 0
    logs: torch.Tensor  # log1p(-a)
    cums: torch.Tensor  # in-block inclusive prefix of logs
    lT: torch.Tensor  # [m, 256, 1] log T before the block
    blend: torch.Tensor  # bool: blended
    trigger: torch.Tensor  # bool: stops its pixel, not blended


def _plain_block(payload, b0, start, cnt, tiles, act, i, px, py, done, logT) -> _Block:
    """Block i of the active tiles' runs, in the JAX kernel's log-space
    prefix form (tile_raster2._block_alpha / _blend_masks_log)."""
    tg = tiles[act]
    bidx = b0[tg] + i
    blk = payload[bidx]  # [m, c_pad, 128]
    glob = bidx[:, None] * CHUNK + torch.arange(CHUNK, device=payload.device)[None, :]
    slot_valid = (glob >= start[tg, None]) & (glob < (start + cnt)[tg, None])
    mx, my, ca, cb, cc, op = blk[:, :PAYLOAD_HEADER, None, :].unbind(1)  # [m, 1, 128] each
    dx = mx - px[act][:, :, None]  # [m, 256, 128]
    dy = my - py[act][:, :, None]
    power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
    apow = torch.exp(torch.clamp(power, max=0.0))
    alpha_raw = op * apow
    alpha = torch.clamp(alpha_raw, max=ALPHA_MAX)
    active = (
        (power <= 0.0) & (alpha >= ALPHA_MIN)
        & ~done[act][:, :, None] & slot_valid[:, None, :]
    )
    a = torch.where(active, alpha, 0.0)
    logs = torch.log1p(-a)
    cums = torch.cumsum(logs, dim=2)
    lT = logT[act][:, :, None]
    not_term = lT + cums >= LOG_T_EPS
    return _Block(
        bidx, blk, slot_valid, dx, dy, (ca, cb, cc), apow, alpha_raw, a, logs, cums, lT,
        blend=(a > 0.0) & not_term, trigger=(a > 0.0) & ~not_term,
    )


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
    nblocks = run_blocks(tile_start, tile_count)
    b0 = start // CHUNK
    out = torch.empty((num_tiles, PIX, F + 1), dtype=torch.float32, device=dev)
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
            k = _plain_block(payload, b0, start, cnt, tiles, act, i, px, py, done, logT)
            w = torch.where(k.blend, k.a * torch.exp(k.lT + k.cums - k.logs), 0.0)
            feat = k.blk[:, PAYLOAD_HEADER:PAYLOAD_HEADER + F, :]  # [m, F, 128]
            if return_work:
                # lanes up to and including the stopping one: those
                # whose exclusive prefix had not yet terminated
                reached = k.lT + (k.cums - k.logs) >= LOG_T_EPS
                evaluated = k.slot_valid[:, None, :] & ~done[act][:, :, None] & reached
                work["evaluated"] += evaluated.sum()
                work["blended"] += k.blend.sum()
            accum[act] += torch.einsum("mpl,mfl->mpf", w, feat)
            logT[act] += torch.where(k.blend, k.logs, 0.0).sum(dim=2)
            done[act] |= k.trigger.any(dim=2)
        out[tiles, :, :F] = accum
        out[tiles, :, F] = torch.exp(logT)
    return (out, work) if return_work else out


def _check_args(payload, tile_start, tile_count, num_features, num_tiles):
    if not 1 <= num_features <= MAX_FEATURES:
        raise ValueError(
            f"tile_blend_instances: the kernels take 1..{MAX_FEATURES} features (MAX_FEATURES), "
            f"got {num_features}"
        )
    if payload.dim() != 3 or payload.shape[2] != CHUNK or payload.dtype != torch.float32:
        raise ValueError(f"tile_blend_instances: payload must be [NB+1, c_pad, {CHUNK}] float32")
    if payload.shape[1] < PAYLOAD_HEADER + num_features:
        raise ValueError("tile_blend_instances: payload has fewer rows than 6 + F")
    for name, t in (("tile_start", tile_start), ("tile_count", tile_count)):
        if t.shape != (num_tiles,) or t.dtype != torch.int32:
            raise ValueError(f"tile_blend_instances: {name} must be [{num_tiles}] int32")
        if t.device != payload.device:
            raise ValueError(f"tile_blend_instances: {name} is not on the payload's device")


class BlendState(NamedTuple):
    """What the forward kernel leaves on the card beside its output: the
    work list and the long tiles' boundary state, which the backward
    kernel's segments enter with."""

    plan: torch.Tensor  # int32 [2 + num_tiles + 2 * max_items], see blend_common.cuh
    # [payload blocks, 256] a block's per-pixel sum of log1p(-alpha); only
    # the blocks of the long tiles' segments but their last are written
    blocklog: torch.Tensor
    part: torch.Tensor  # [max_long, 256, F + 1] a segment's partial accumulator and T
    seg_blocks: int
    max_items: int


def run_blocks(tile_start: torch.Tensor, tile_count: torch.Tensor) -> torch.Tensor:
    """Payload blocks each tile's run touches (int64)."""
    start, cnt = tile_start.to(torch.int64), tile_count.to(torch.int64)
    return torch.where(cnt > 0, (start % CHUNK + cnt + CHUNK - 1) // CHUNK, 0)


def plan_bounds(num_payload_blocks: int, num_tiles: int, seg_blocks: int):
    """(max_long, max_items): upper bounds, from the shapes alone, of the
    work list's items of long tiles and of its items in all. The runs are
    disjoint, so the blocks they touch sum to at most num_payload_blocks
    + num_tiles (a boundary block counts twice); a long tile touches
    more than seg_blocks, so its ceil(blocks / seg_blocks) segments are
    fewer than 2 blocks / seg_blocks. No run touches more blocks than
    the payload has, so with seg_blocks at or beyond that none is long."""
    if seg_blocks >= num_payload_blocks:
        return 0, num_tiles
    max_long = 2 * (num_payload_blocks + num_tiles) // seg_blocks + 1
    return max_long, num_tiles + max_long


def blend_plan_plain(tile_start: torch.Tensor, tile_count: torch.Tensor, seg_blocks: int) -> dict:
    """Plain PyTorch version of the kernels' work list (plan_kernel in
    csrc/tile_blend.cu): every tile's run cut at each seg_blocks-th
    payload block it touches. Items of long tiles (more than one
    segment) first, in tile order, a tile's segments in a row; then one
    item per other tile. Returns n_long, n_items, tile_slot [num_tiles]
    (a long tile's first item, else -1), item_tile and item_seg
    [n_items]."""
    dev = tile_start.device
    nseg = ((run_blocks(tile_start, tile_count) + seg_blocks - 1) // seg_blocks).clamp(min=1)
    long_tiles = (nseg > 1).nonzero().squeeze(1)
    short_tiles = (nseg == 1).nonzero().squeeze(1)
    n = nseg[long_tiles]
    first = torch.cumsum(n, 0) - n
    n_long = int(n.sum())
    tile_slot = torch.full_like(nseg, -1)
    tile_slot[long_tiles] = first
    seg = torch.arange(n_long, device=dev) - torch.repeat_interleave(first, n)
    return {
        "n_long": n_long, "n_items": n_long + short_tiles.numel(),
        "tile_slot": tile_slot.to(torch.int32),
        "item_tile": torch.cat([torch.repeat_interleave(long_tiles, n), short_tiles]).to(torch.int32),
        "item_seg": torch.cat([seg, torch.zeros_like(short_tiles)]).to(torch.int32),
    }


def blend_plan(tile_start: torch.Tensor, tile_count: torch.Tensor, num_payload_blocks: int,
               seg_blocks: int) -> dict:
    """The work list as the kernels build it (a CPU tensor: the plain
    version), read back in blend_plan_plain's form. For checks: the
    kernels themselves read it on the card."""
    if tile_start.device.type == "cpu":
        return blend_plan_plain(tile_start, tile_count, seg_blocks)
    _build.require_cuda(tile_start, "blend_plan")
    T = tile_start.numel()
    _, max_items = plan_bounds(num_payload_blocks, T, seg_blocks)
    plan = torch.full((2 + T + 2 * max_items,), -2, dtype=torch.int32, device=tile_start.device)
    lib = _build.load("tile_blend", _bind, BUILD_FLAGS)
    err = lib.tile_blend_plan(
        _build.ptr(tile_start.contiguous()), _build.ptr(tile_count.contiguous()), _build.ptr(plan),
        T, seg_blocks, max_items, _build.stream_of(plan),
    )
    _build.check(err, "blend_plan")
    n_long, n_items = plan[:2].tolist()
    items = plan[2 + T:]
    return {"n_long": n_long, "n_items": n_items, "tile_slot": plan[2:2 + T],
            "item_tile": items[:n_items], "item_seg": items[max_items:max_items + n_items]}


def _launch_forward(payload, tile_start, tile_count, num_features, grid_x, num_tiles, want_out=True):
    """Launch csrc/tile_blend.cu on checked, contiguous CUDA tensors.
    Returns (out, BlendState); with want_out False only the boundary
    state is computed (the long tiles' items) and out is None."""
    dev = payload.device
    seg_blocks = SEG // CHUNK
    max_long, max_items = plan_bounds(payload.shape[0], num_tiles, seg_blocks)
    state = BlendState(
        plan=torch.empty(2 + num_tiles + 2 * max_items, dtype=torch.int32, device=dev),
        blocklog=torch.empty((payload.shape[0], PIX), dtype=torch.float32, device=dev),
        part=torch.empty((max_long, PIX, num_features + 1), dtype=torch.float32, device=dev),
        seg_blocks=seg_blocks, max_items=max_items,
    )
    out = None
    if want_out:
        out = torch.empty((num_tiles, PIX, num_features + 1), dtype=torch.float32, device=dev)
    lib = _build.load("tile_blend", _bind, BUILD_FLAGS)
    err = lib.tile_blend_fwd(
        _build.ptr(payload), _build.ptr(tile_start), _build.ptr(tile_count),
        _build.ptr(state.plan), _build.ptr(state.blocklog), _build.ptr(state.part),
        _build.ptr(out) if want_out else None,
        num_tiles, grid_x, payload.shape[1], num_features, seg_blocks, max_long, max_items,
        _build.stream_of(payload),
    )
    _build.check(err, "tile_blend_instances")
    return out, state


def _forward(payload, tile_start, tile_count, num_features, grid_x, num_tiles):
    """tile_blend_instances plus the kernel's BlendState (None on the
    CPU, where the plain version runs)."""
    _check_args(payload, tile_start, tile_count, num_features, num_tiles)
    if payload.device.type == "cpu":
        out = tile_blend_plain(payload, tile_start, tile_count, num_features, grid_x, num_tiles)
        return out, None
    _build.require_cuda(payload, "tile_blend_instances")
    res = _launch_forward(
        payload.contiguous(), tile_start.contiguous(), tile_count.contiguous(),
        num_features, grid_x, num_tiles,
    )
    tile_blend_instances.launches += 1
    return res


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
    return _forward(payload, tile_start, tile_count, num_features, grid_x, num_tiles)[0]


tile_blend_instances.launches = 0


def _bind_bwd(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.tile_blend_bwd.argtypes = [p] * 9 + [i] * 6 + [p]
    lib.tile_blend_bwd.restype = ctypes.c_int


def tile_blend_bwd_plain(
    payload: torch.Tensor,
    tile_start: torch.Tensor,
    tile_count: torch.Tensor,
    out: torch.Tensor,
    gout: torch.Tensor,
    num_features: int,
    grid_x: int,
    num_tiles: int,
) -> torch.Tensor:
    """Plain PyTorch version of the backward: vectorised over tiles,
    sequential over each run's 128-lane blocks, in the JAX kernel's form
    (the suffix as S_total minus the prefix of u, the blend masks from
    the forward's log-space prefix). Returns d_payload, the shape of
    payload, zero outside the live runs."""
    F = num_features
    dev = payload.device
    start = tile_start.to(torch.int64)
    cnt = tile_count.to(torch.int64)
    nblocks = run_blocks(tile_start, tile_count)
    b0 = start // CHUNK
    d_payload = torch.zeros_like(payload)
    for t0 in range(0, num_tiles, _PLAIN_TILES):
        tiles = torch.arange(t0, min(t0 + _PLAIN_TILES, num_tiles), device=dev)
        n = tiles.numel()
        px, py = _pixel_coords(tiles, grid_x)
        g = gout[tiles, :, :F]  # [n, 256, F]
        s_total = (g * out[tiles, :, :F]).sum(dim=2)
        gt_tfin = gout[tiles, :, F] * out[tiles, :, F]
        logT = torch.zeros((n, PIX), dtype=torch.float32, device=dev)
        u_prev = torch.zeros((n, PIX), dtype=torch.float32, device=dev)
        done = torch.zeros((n, PIX), dtype=torch.bool, device=dev)
        nb = nblocks[tiles]
        for i in range(int(nb.max()) if n else 0):
            act = ((i < nb) & ~done.all(dim=1)).nonzero().squeeze(1)
            if act.numel() == 0:
                break
            k = _plain_block(payload, b0, start, cnt, tiles, act, i, px, py, done, logT)
            dx, dy, (ca, cb, cc), a = k.dx, k.dy, k.conic, k.a
            tprefix = torch.exp(k.lT + k.cums - k.logs)
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
            # a boundary block is shared by two tiles of this step, never
            # a lane: add each tile's own lanes into the zeros
            new_rows = torch.where(k.slot_valid[:, None, :], new_rows, 0.0)
            d_payload[:, : PAYLOAD_HEADER + F + ABS_ROWS].index_add_(0, k.bidx, new_rows)
            logT[act] += torch.where(k.blend, k.logs, 0.0).sum(dim=2)
            u_prev[act] += u.sum(dim=2)
            done[act] |= k.trigger.any(dim=2)
    return d_payload


def tile_blend_bwd(
    payload: torch.Tensor,
    tile_start: torch.Tensor,
    tile_count: torch.Tensor,
    out: torch.Tensor,
    gout: torch.Tensor,
    num_features: int,
    grid_x: int,
    num_tiles: int,
    state: Optional[BlendState] = None,
) -> torch.Tensor:
    """Gradient of tile_blend_instances' payload given its output `out`
    and the output's cotangent `gout` (both [num_tiles, 256, F+1]).
    `state` is the forward kernel's BlendState for the same payload and
    runs, as TileBlendInstances keeps it; without it the kernel path
    first recomputes it (the forward's work list and the long tiles'
    boundary state), which gives the same gradient bit for bit."""
    _check_args(payload, tile_start, tile_count, num_features, num_tiles)
    shape = (num_tiles, PIX, num_features + 1)
    for name, t in (("out", out), ("gout", gout)):
        if tuple(t.shape) != shape or t.dtype != torch.float32 or t.device != payload.device:
            raise ValueError(f"tile_blend_bwd: {name} must be {list(shape)} float32 on the payload's device")
    if payload.shape[1] < payload_rows(num_features):
        raise ValueError("tile_blend_bwd: payload has fewer rows than payload_rows(F)")
    if payload.device.type == "cpu":
        return tile_blend_bwd_plain(
            payload, tile_start, tile_count, out, gout, num_features, grid_x, num_tiles
        )
    _build.require_cuda(payload, "tile_blend_bwd")
    payload, tile_start, tile_count, out, gout = (
        t.contiguous() for t in (payload, tile_start, tile_count, out, gout)
    )
    if state is None:
        _, state = _launch_forward(
            payload, tile_start, tile_count, num_features, grid_x, num_tiles, want_out=False
        )
    d_payload = torch.zeros_like(payload)
    lib = _build.load("tile_blend_bwd", _bind_bwd, BUILD_FLAGS)
    err = lib.tile_blend_bwd(
        _build.ptr(payload), _build.ptr(tile_start), _build.ptr(tile_count),
        _build.ptr(state.plan), _build.ptr(state.blocklog), _build.ptr(state.part),
        _build.ptr(out), _build.ptr(gout), _build.ptr(d_payload),
        num_tiles, grid_x, payload.shape[1], num_features, state.seg_blocks, state.max_items,
        _build.stream_of(payload),
    )
    _build.check(err, "tile_blend_bwd")
    tile_blend_bwd.launches += 1
    return d_payload


tile_blend_bwd.launches = 0


class TileBlendInstances(torch.autograd.Function):
    """tile_blend_instances with tile_blend_bwd as its gradient (the
    payload's only; the run descriptors are integers). On the card the
    forward kernel's BlendState is kept for the backward kernel."""

    @staticmethod
    def forward(ctx, payload, tile_start, tile_count, num_features, grid_x, num_tiles):
        out, ctx.state = _forward(payload, tile_start, tile_count, num_features, grid_x, num_tiles)
        ctx.save_for_backward(payload, tile_start, tile_count, out)
        ctx.dims = (num_features, grid_x, num_tiles)
        return out

    @staticmethod
    def backward(ctx, gout):
        payload, tile_start, tile_count, out = ctx.saved_tensors
        d_payload = tile_blend_bwd(
            payload, tile_start, tile_count, out, gout.contiguous(), *ctx.dims, state=ctx.state
        )
        return d_payload, None, None, None, None, None
