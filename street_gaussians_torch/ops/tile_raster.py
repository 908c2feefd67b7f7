"""Dense-table tile blend: forward and backward.

Replaces street_gaussians_tpu/ops/tile_raster.py::_fwd_kernel with
`csrc/tile_blend_table.cu` and its `_bwd_kernel` with
`csrc/tile_blend_table_bwd.cu`. Tile t owns payload[t], a [c_pad, K]
table of its depth-ordered Gaussians (ops/binning.bin_gaussians); the
rows are those of ops/tile_raster2.py, and opacity 0 marks an empty
slot. `tile_count[t]` only sets how many 128-lane chunks of the table
are read, cdiv(count, 128) and at most K / 128: the blend never masks a lane by the count
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

Bound on the H100: the forward by the per-pixel exp and arithmetic, far
above the bytes of the live chunks; the backward by the bytes of the
whole gradient table beside that arithmetic. Both kernels work through a
list of items built on the card (csrc/blend_common.cuh's build_plan): a
tile of more than SEG_CHUNKS 128-lane chunks is cut into segments of
that many chunks, each its own block of 256 threads (one per pixel). A
first pass gives each chunk of a long tile's segments every pixel's
product of (1 - alpha) over its passing lanes, with no stop; a segment
enters with the earlier chunks' products folded in chunk order, which is
the unsplit walk's T bit for bit while the pixel has not stopped, and
below 1e-4 exactly when it has; the segments' partial accumulators are
added in segment order. The wrapper reads the list's two counts back
(one sync a call, none when K is too short for a tile to be cut) and
sizes the launches and the boundary state
(`TableState`) from them; the forward keeps that state on the card for
the backward. No block shares a slot with another, so the backward
writes its own slots without atomics, and it writes every element of
the gradient table once (zeros where the walk does not reach), so
d_payload needs no zero fill. See the notes at the head of the two
sources for the rest (alpha in batches, cp.async staging, the
backward's lane-parallel 256-pixel sums).

F = 1..8 is instantiated; F = 9..64 (tile_raster2.MAX_FEATURES) takes
the kernels' runtime-count variants, the chunk's rows and the
per-feature state in shared memory; a wider F raises.

`tile_blend` and `tile_blend_bwd` run their plain PyTorch versions for a
CPU tensor and their kernels for a CUDA tensor. `TileBlend` is the
autograd Function around the two. `table_plan_plain` is the plain
version of the kernels' work list.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from street_gaussians_torch.kernels import _build
from street_gaussians_torch.ops import tile_raster2
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
from street_gaussians_torch.utils.trace import span


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


# chunks per segment of a long tile (the kernels only): a tile of more
# than SEG_CHUNKS 128-lane chunks is cut. 16 (2,048 lanes) is 2-7% faster
# than the main path's 8 on the bench table in both directions at F = 4
# and 27, and 24 no faster (script.block_times --table --seg, NVIDIA H100
# 80GB HBM3 at 700 W)
SEG_CHUNKS = 16


def max_items_bound(num_tiles: int, capacity: int, seg_chunks: int) -> int:
    """Items the work list can hold, from the shapes alone: every tile cut
    into its most segments (the list's own size; the launches take the
    counts the list reports)."""
    return num_tiles * max(1, -(-(capacity // CHUNK) // seg_chunks))


def table_plan_plain(tile_count: torch.Tensor, capacity: int, seg_chunks: int) -> dict:
    """Plain PyTorch version of the kernels' work list (plan_kernel in
    csrc/tile_blend_table.cu): a tile of more than seg_chunks chunks cut
    into segments of seg_chunks chunks, in
    tile_raster2.plan_from_segments's order and form."""
    nseg = ((_num_chunks(tile_count, capacity) + seg_chunks - 1) // seg_chunks).clamp(min=1)
    return tile_raster2.plan_from_segments(nseg)


class TableState(NamedTuple):
    """What the forward kernel leaves on the card beside its output: the
    work list and the long tiles' boundary state, which the backward
    kernel's segments enter with."""

    plan: torch.Tensor  # int32 [2 + num_tiles + 2 * max_items], see blend_common.cuh
    # [n_long * seg_chunks, 256] per chunk of a long tile's segments (the
    # last segment's left unwritten): each pixel's product of (1 - alpha)
    prod: torch.Tensor
    part: torch.Tensor  # [n_long, 256, F + 1] a segment's partial accumulator and T
    seg_chunks: int
    n_long: int
    n_items: int
    max_items: int


def _bind(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.tile_blend_table_plan.argtypes = [p, p, i, i, i, i, p]
    lib.tile_blend_table_plan.restype = ctypes.c_int
    lib.tile_blend_table_fwd.argtypes = [p] * 6 + [i] * 9 + [p]
    lib.tile_blend_table_fwd.restype = ctypes.c_int


def _launch_plan(tile_count: torch.Tensor, capacity: int, seg_chunks: int):
    """(plan, n_long, n_items, max_items): the work list built on the card
    and its two counts, read back to size the launches; when the table
    is too short for any tile to be cut, every tile is one item and
    nothing is read back."""
    T = tile_count.numel()
    max_items = max_items_bound(T, capacity, seg_chunks)
    plan = torch.zeros(2 + T + 2 * max_items, dtype=torch.int32, device=tile_count.device)
    lib = _build.load("tile_blend_table", _bind, tile_raster2.BUILD_FLAGS)
    err = lib.tile_blend_table_plan(
        _build.ptr(tile_count), _build.ptr(plan), T, capacity, seg_chunks, max_items,
        _build.stream_of(tile_count),
    )
    _build.check(err, "tile_blend")
    if max_items == T:
        return plan, 0, T, max_items
    with span("sync/table_plan"):
        n_long, n_items = plan[:2].tolist()
    return plan, n_long, n_items, max_items


def table_plan(tile_count: torch.Tensor, capacity: int, seg_chunks: int) -> dict:
    """The work list as the kernels build it (a CPU tensor: the plain
    version), read back in table_plan_plain's form. For checks: the
    kernels themselves read it on the card."""
    if tile_count.device.type == "cpu":
        return table_plan_plain(tile_count, capacity, seg_chunks)
    _build.require_cuda(tile_count, "table_plan")
    plan, n_long, n_items, max_items = _launch_plan(tile_count.contiguous(), capacity, seg_chunks)
    T = tile_count.numel()
    items = plan[2 + T:]
    return {"n_long": n_long, "n_items": n_items, "tile_slot": plan[2:2 + T],
            "item_tile": items[:n_items], "item_seg": items[max_items:max_items + n_items]}


def _launch_forward(payload, tile_count, num_features, grid_x, want_out=True):
    """Launch csrc/tile_blend_table.cu on checked, contiguous CUDA tensors.
    Returns (out, TableState); with want_out False only the boundary state
    is computed (the long tiles' items) and out is None."""
    dev = payload.device
    num_tiles, c_pad, K = payload.shape
    seg_chunks = SEG_CHUNKS
    plan, n_long, n_items, max_items = _launch_plan(tile_count, K, seg_chunks)
    state = TableState(
        plan=plan,
        prod=torch.empty((n_long * seg_chunks, PIX), dtype=torch.float32, device=dev),
        part=torch.empty((n_long, PIX, num_features + 1), dtype=torch.float32, device=dev),
        seg_chunks=seg_chunks, n_long=n_long, n_items=n_items, max_items=max_items,
    )
    out = None
    if want_out:
        out = torch.empty((num_tiles, PIX, num_features + 1), dtype=torch.float32, device=dev)
    lib = _build.load("tile_blend_table", _bind, tile_raster2.BUILD_FLAGS)
    err = lib.tile_blend_table_fwd(
        _build.ptr(payload), _build.ptr(tile_count), _build.ptr(plan), _build.ptr(state.prod),
        _build.ptr(state.part), _build.ptr(out) if want_out else None,
        num_tiles, grid_x, c_pad, K, num_features, seg_chunks, n_long, n_items, max_items,
        _build.stream_of(payload),
    )
    _build.check(err, "tile_blend")
    return out, state


def _forward(payload, tile_count, num_features, grid_x):
    """tile_blend plus the kernel's TableState (None on the CPU, where the
    plain version runs)."""
    _check_args("tile_blend", payload, tile_count, num_features)
    if payload.device.type == "cpu":
        return tile_blend_plain(payload, tile_count, num_features, grid_x), None
    _build.require_cuda(payload, "tile_blend")
    res = _launch_forward(payload.contiguous(), tile_count.contiguous(), num_features, grid_x)
    tile_blend.launches += 1
    return res


def tile_blend(
    payload: torch.Tensor, tile_count: torch.Tensor, num_features: int, grid_x: int
) -> torch.Tensor:
    """Alpha-blend each tile's table. payload [num_tiles, c_pad, K],
    tile_count [num_tiles] int32. Returns [num_tiles, 256, F+1]."""
    return _forward(payload, tile_count, num_features, grid_x)[0]


tile_blend.launches = 0


def _bind_bwd(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.tile_blend_table_bwd.argtypes = [p] * 8 + [i] * 8 + [p]
    lib.tile_blend_table_bwd.restype = ctypes.c_int


def tile_blend_bwd(
    payload: torch.Tensor,
    tile_count: torch.Tensor,
    out: torch.Tensor,
    gout: torch.Tensor,
    num_features: int,
    grid_x: int,
    state: Optional[TableState] = None,
) -> torch.Tensor:
    """Gradient of tile_blend's payload given its output `out` and the
    output's cotangent `gout` (both [num_tiles, 256, F+1]). `state` is
    the forward kernel's TableState for the same payload and counts, as
    TileBlend keeps it; without it the kernel path first recomputes it,
    which gives the same gradient bit for bit."""
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
    if state is None:
        _, state = _launch_forward(payload, tile_count, num_features, grid_x, want_out=False)
    d_payload = torch.empty_like(payload)  # the kernel writes every element
    lib = _build.load("tile_blend_table_bwd", _bind_bwd, tile_raster2.BUILD_FLAGS)
    err = lib.tile_blend_table_bwd(
        _build.ptr(payload), _build.ptr(tile_count), _build.ptr(state.plan), _build.ptr(state.prod),
        _build.ptr(state.part), _build.ptr(out), _build.ptr(gout), _build.ptr(d_payload),
        num_tiles, grid_x, c_pad, K, num_features, state.seg_chunks, state.n_items,
        state.max_items, _build.stream_of(payload),
    )
    _build.check(err, "tile_blend_bwd")
    tile_blend_bwd.launches += 1
    return d_payload


tile_blend_bwd.launches = 0


class TileBlend(torch.autograd.Function):
    """tile_blend with tile_blend_bwd as its gradient (the payload's
    only; the counts are integers). On the card the forward kernel's
    TableState is kept for the backward kernel."""

    @staticmethod
    def forward(ctx, payload, tile_count, num_features, grid_x):
        out, ctx.state = _forward(payload, tile_count, num_features, grid_x)
        ctx.save_for_backward(payload, tile_count, out)
        ctx.dims = (num_features, grid_x)
        return out

    @staticmethod
    def backward(ctx, gout):
        payload, tile_count, out = ctx.saved_tensors
        with span("tile_blend_bwd"):
            d_payload = tile_blend_bwd(payload, tile_count, out, gout.contiguous(), *ctx.dims, state=ctx.state)
        return d_payload, None, None, None
