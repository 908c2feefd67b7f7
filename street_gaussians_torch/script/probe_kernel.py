"""Ablation probe of the instance-major tile blend at bench scale.

Counterpart of the JAX package's script/probe_kernel.py. It times the
blend's forward kernel against two variants on the bench frame's payload
(1600x1064, 220,000 background points grown x3, 4 actors, frame 2, eval
mode, instance_capacity 2^21, tile_capacity 1024):

  floor    reads every payload block of every tile's run, with no blend
           arithmetic (`probe_floor`)
  current  ops/tile_raster2.tile_blend_instances (kernel 2.1)
  variant  the same function with the in-block prefix sums as products
           with a triangular 0/1 matrix on the tensor cores
           (`probe_blend_mma`)

all three at kernel 2.1's decomposition: the floor and the variant walk
its work list (runs longer than SEG lanes cut into segments, one thread
block each). It prints max |current - variant|, and times forward +
backward of the current kernels under the loss sum(out * out) * 1e-6.

    python -m street_gaussians_torch.script.probe_kernel [--iters 20]

Both variants are `csrc/probe_blend.cu` (see its head for the design).
On a CPU tensor `probe_floor` runs `probe_floor_plain` and
`probe_blend_mma` runs the blend's plain version, which computes the same
function; `probe_blend_mma_split_plain` repeats the variant's segment
algebra in plain PyTorch for the checks.
"""

from __future__ import annotations

import argparse
import ctypes
import json
from typing import Callable, Dict

import torch

from street_gaussians_torch._device import resolve_device, time_ms
from street_gaussians_torch.data.synthetic import make_synthetic_scene
from street_gaussians_torch.kernels import _build
from street_gaussians_torch.models.renderer import RenderOptions, SceneParams, screen_space
from street_gaussians_torch.ops import tile_raster2
from street_gaussians_torch.ops.rasterize import RasterizeConfig, blend_inputs
from street_gaussians_torch.ops.tile_raster2 import CHUNK, LOG_T_EPS, PAYLOAD_HEADER, PIX

FLOOR_ROWS = 8  # payload rows the floor sums
# feature counts csrc/probe_blend.cu is instantiated for (kernel 2.1 at
# F = 4 is what it ablates)
MAX_FEATURES = 8
# more nvcc flags for the library: script/block_times.py sets a probe
# build here for the length of its measurement
BUILD_FLAGS: tuple = ()


def _bind(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.probe_floor.argtypes = [p] * 6 + [i] * 6 + [p]
    lib.probe_blend_mma.argtypes = [p] * 7 + [i] * 7 + [p]
    for fn in (lib.probe_floor, lib.probe_blend_mma):
        fn.restype = ctypes.c_int


def probe_floor_plain(payload, tile_start, tile_count, num_features, grid_x, num_tiles):
    """Plain PyTorch version of the floor: for each tile, the sums of
    rows 0..7 of the payload blocks its run touches, added block by
    block, in all [256, F] outputs; T = 1."""
    start = tile_start.to(torch.int64)
    cnt = tile_count.to(torch.int64)
    nblocks = torch.where(cnt > 0, (start % CHUNK + cnt + CHUNK - 1) // CHUNK, 0)
    b0 = start // CHUNK
    block_sums = payload[:, :FLOOR_ROWS, :].sum(dim=(1, 2))
    acc = torch.zeros(num_tiles, dtype=torch.float32, device=payload.device)
    for i in range(int(nblocks.max()) if num_tiles else 0):
        act = (i < nblocks).nonzero().squeeze(1)
        acc[act] += block_sums[b0[act] + i]
    out = acc[:, None, None].expand(num_tiles, PIX, num_features + 1).clone()
    out[:, :, num_features] = 1.0
    return out


def _launch(entry: str, payload, tile_start, tile_count, num_features, grid_x, num_tiles):
    """Launch `entry` of csrc/probe_blend.cu on kernel 2.1's work list
    (segments of SEG / 128 payload blocks), sized by the shapes' bounds."""
    _build.require_cuda(payload, entry)
    if not 1 <= num_features <= MAX_FEATURES:
        raise ValueError(f"{entry}: the kernel takes 1..{MAX_FEATURES} features, got {num_features}")
    payload, tile_start, tile_count = (t.contiguous() for t in (payload, tile_start, tile_count))
    dev = payload.device
    seg_blocks = tile_raster2.SEG // CHUNK
    max_long, max_items = tile_raster2.plan_bounds(payload.shape[0], num_tiles, seg_blocks)
    plan = torch.empty(2 + num_tiles + 2 * max_items, dtype=torch.int32, device=dev)
    out = torch.empty((num_tiles, PIX, num_features + 1), dtype=torch.float32, device=dev)
    fn = getattr(_build.load("probe_blend", _bind, BUILD_FLAGS), entry)
    ptr = _build.ptr
    if entry == "probe_floor":
        part = torch.empty(max(max_long, 1), dtype=torch.float32, device=dev)
        err = fn(ptr(payload), ptr(tile_start), ptr(tile_count), ptr(plan), ptr(part), ptr(out),
                 num_tiles, payload.shape[1], num_features, seg_blocks, max_long, max_items,
                 _build.stream_of(payload))
    else:
        blocklog = torch.empty((payload.shape[0], PIX), dtype=torch.float32, device=dev)
        part = torch.empty((max_long, PIX, num_features + 1), dtype=torch.float32, device=dev)
        err = fn(ptr(payload), ptr(tile_start), ptr(tile_count), ptr(plan), ptr(blocklog), ptr(part),
                 ptr(out), num_tiles, grid_x, payload.shape[1], num_features, seg_blocks, max_long,
                 max_items, _build.stream_of(payload))
    _build.check(err, entry)
    return out


def probe_floor(payload, tile_start, tile_count, num_features, grid_x, num_tiles):
    """The floor variant; arguments and output shape as
    tile_raster2.tile_blend_instances."""
    args = (payload, tile_start, tile_count, num_features, grid_x, num_tiles)
    tile_raster2._check_args(payload, tile_start, tile_count, num_features, num_tiles)
    if payload.shape[1] < FLOOR_ROWS:
        raise ValueError(f"probe_floor: payload has fewer than {FLOOR_ROWS} rows")
    if payload.device.type == "cpu":
        return probe_floor_plain(*args)
    out = _launch("probe_floor", *args)
    probe_floor.launches += 1
    return out


probe_floor.launches = 0


def probe_blend_mma(payload, tile_start, tile_count, num_features, grid_x, num_tiles):
    """The tensor-core prefix variant of tile_blend_instances: the same
    function, so its plain version is tile_raster2.tile_blend_plain."""
    args = (payload, tile_start, tile_count, num_features, grid_x, num_tiles)
    tile_raster2._check_args(*args[:4], num_tiles)
    if payload.device.type == "cpu":
        return tile_raster2.tile_blend_plain(*args)
    out = _launch("probe_blend_mma", *args)
    probe_blend_mma.launches += 1
    return out


probe_blend_mma.launches = 0

# lanes a tensor-core product spans (csrc/probe_blend.cu's slabs)
SLAB = 8
# items the split emulation walks together (bounds its [items, 256, 128]
# temporaries)
_SPLIT_ITEMS = 256


def _block_prefix(logs: torch.Tensor):
    """The variant's in-block prefix of logs [m, 256, 128]: for each slab
    of 8 lanes its inclusive prefix `loc` = logs x L and total `tot` =
    logs x ones (column 7 of L is all ones), each the f32 rounding of the
    exact sum (the f64 sums of at most 8 of these f32 logs are exact); the
    prefix before a slab, R, carried in f32 adds. Returns (S = R + loc
    [m, 256, 128], R after the last slab [m, 256])."""
    m = logs.shape[0]
    L = torch.triu(torch.ones((SLAB, SLAB), dtype=torch.float64, device=logs.device))
    loc = (logs.double().reshape(m, PIX, CHUNK // SLAB, SLAB) @ L).float()
    R = torch.zeros((m, PIX), dtype=torch.float32, device=logs.device)
    before = []
    for n in range(CHUNK // SLAB):
        before.append(R)
        R = R + loc[:, :, n, SLAB - 1]
    S = torch.stack(before, dim=2)[..., None] + loc
    return S.reshape(m, PIX, CHUNK), R


def probe_blend_mma_split_plain(payload, tile_start, tile_count, num_features, grid_x, num_tiles,
                                seg_blocks: int, return_state: bool = False):
    """Plain PyTorch repetition of probe_blend_mma's design, for the
    checks: kernel 2.1's work list at seg_blocks payload blocks a
    segment; a first pass giving each block of a long tile's segments
    but its last R, its per-pixel log-sum from the block's products
    (`_block_prefix`), over every passing lane; a segment entering with
    the fold of the earlier blocks' R in block order; each item walking
    its blocks from that state alone, the stop test and the weights on S
    = R + loc, a pixel stopping at the first flagged lane (the flag
    prefix still 0 before it) and folding logT += R at the end of a
    block it crosses; the partials added in segment order. Returns
    tile_blend_instances' output and, with return_state, per tile and
    pixel the lane of the run at which the pixel stopped (-1: never) and
    the number of lanes it blended, and per item whether the pixel
    entered it."""
    F = num_features
    dev = payload.device
    plan = tile_raster2.blend_plan_plain(tile_start, tile_count, seg_blocks)
    n_long = plan["n_long"]
    tile = plan["item_tile"].long()
    seg = plan["item_seg"].long()
    n = tile.numel()
    start = tile_start.long()[tile]
    cnt = tile_count.long()[tile]
    b0 = start // CHUNK
    b_end = b0 + tile_raster2.run_blocks(tile_start, tile_count)[tile]
    b_first = b0 + seg * seg_blocks
    b_stop = torch.minimum(b_first + seg_blocks, b_end)
    last = b_stop == b_end
    items = torch.arange(n, device=dev)
    px, py = tile_raster2._pixel_coords(tile, grid_x)
    no = torch.zeros((n, PIX), dtype=torch.bool, device=dev)
    zero = torch.zeros((n, PIX), dtype=torch.float32, device=dev)

    def block(act, i, done):
        k = tile_raster2._plain_block(payload, b_first, start, cnt, items, act, i, px, py, done, zero)
        return k, _block_prefix(k.logs)

    # the first pass
    blocklog = torch.zeros((payload.shape[0], PIX), dtype=torch.float32, device=dev)
    cut = items[:n_long][~last[:n_long]]
    for c0 in range(0, cut.numel(), _SPLIT_ITEMS):
        for i in range(seg_blocks):  # the segments but the last are whole
            act = cut[c0:c0 + _SPLIT_ITEMS]
            _, (_, R) = block(act, i, no)
            blocklog[b_first[act] + i] = R
    # the entering state: the fold of the earlier blocks' sums
    logT = torch.zeros((n, PIX), dtype=torch.float32, device=dev)
    for j in range(int((b_first - b0).max()) if n else 0):
        has = (j < b_first - b0)[:, None]
        logT = torch.where(has, logT + blocklog[torch.clamp(b0 + j, max=payload.shape[0] - 1)], logT)
    entered = logT >= LOG_T_EPS
    done = ~entered
    accum = torch.zeros((n, PIX, F), dtype=torch.float32, device=dev)
    stop_lane = torch.full((n, PIX), -1, dtype=torch.int64, device=dev)
    blended = torch.zeros((n, PIX), dtype=torch.int64, device=dev)
    for i in range(int((b_stop - b_first).max()) if n else 0):
        live = ((b_first + i < b_stop) & ~done.all(dim=1)).nonzero().squeeze(1)
        for c0 in range(0, live.numel(), _SPLIT_ITEMS):
            act = live[c0:c0 + _SPLIT_ITEMS]
            k, (S, R) = block(act, i, done)
            on = k.a > 0.0
            lt = logT[act]
            v = lt[:, :, None] + S
            flag = on & ~(v >= LOG_T_EPS)
            before = torch.cumsum(flag.to(torch.int32), dim=2)  # the flag prefix
            blend = on & (before == 0)
            first = flag & (before == 1)
            w = torch.where(blend, k.a * torch.exp(v - k.logs), 0.0)
            feat = k.blk[:, PAYLOAD_HEADER:PAYLOAD_HEADER + F, :]
            accum[act] += torch.einsum("mpl,mfl->mpf", w, feat)
            blended[act] += blend.sum(dim=2)
            stopped = first.any(dim=2)
            t_stop = torch.where(first, v - k.logs, 0.0).sum(dim=2)
            lane = (k.bidx[:, None] * CHUNK - start[act][:, None]) + first.to(torch.int64).argmax(dim=2)
            stop_lane[act] = torch.where(stopped, lane, stop_lane[act])
            logT[act] = torch.where(stopped, t_stop, torch.where(done[act], lt, lt + R))
            done[act] |= stopped
    t_final = torch.where(entered & (done | last[:, None]), torch.exp(logT), 0.0)
    part = torch.cat([accum, t_final[:, :, None]], dim=2)
    out = torch.zeros((num_tiles, PIX, F + 1), dtype=torch.float32, device=dev)
    out[tile[n_long:]] = part[n_long:]
    for k_seg in range(int(seg[:n_long].max()) + 1 if n_long else 0):  # segment order
        mine = (seg[:n_long] == k_seg).nonzero().squeeze(1)
        out[tile[mine]] += part[mine]
    if not return_state:
        return out
    # a pixel stops in one item of its tile at most
    tile_stop = torch.zeros((num_tiles, PIX), dtype=torch.int64, device=dev)
    tile_stop.index_add_(0, tile, stop_lane + 1)
    tile_stop -= 1
    tile_blended = torch.zeros((num_tiles, PIX), dtype=torch.int64, device=dev)
    tile_blended.index_add_(0, tile, blended)
    return out, {"plan": plan, "stop_lane": tile_stop, "blended": tile_blended, "entered": entered,
                 "item_tile": tile, "item_seg": seg, "blocklog": blocklog}


def run_probe(payload, tile_start, tile_count, num_features, grid_x, num_tiles,
              iters: int = 20, log: Callable[[str], None] = print) -> Dict:
    """Time floor, current and variant on one payload, compare current
    with variant, and time forward + backward of the current kernels."""
    dev = payload.device
    args = (payload, tile_start, tile_count, num_features, grid_x, num_tiles)
    res = {}
    with torch.no_grad():
        for key, name, fn in (
            ("floor_ms", "fwd floor (payload reads + grid only)", probe_floor),
            ("current_ms", "fwd current (sequential prefix)", tile_raster2.tile_blend_instances),
            ("variant_ms", "fwd variant (tensor-core prefix)", probe_blend_mma),
        ):
            res[key] = time_ms(lambda: fn(*args), iters, dev)
            log(f"{name:40s} {res[key]:8.3f} ms")
        diff = (tile_raster2.tile_blend_instances(*args) - probe_blend_mma(*args)).abs().max()
        res["max_abs_diff"] = float(diff)
        log(f"max |current - variant| = {res['max_abs_diff']:.3e}")

    def fwd_bwd():
        p = payload.detach().requires_grad_(True)
        out = tile_raster2.TileBlendInstances.apply(p, *args[1:])
        return torch.autograd.grad((out * out).sum() * 1e-6, p)

    res["fwd_bwd_ms"] = time_ms(fwd_bwd, iters, dev)
    log(f"{'fwd+bwd current':40s} {res['fwd_bwd_ms']:8.3f} ms")
    return res


def bench_payload(device=None, seed: int = 0, frame: int = 2, **overrides):
    """tile_blend_instances' arguments for the bench frame; `overrides`
    replace the scene's size (tests shrink it)."""
    device = resolve_device(device)
    kw = dict(num_bkgd=220_000, num_actors=4, H=1064, W=1600,
              background_growth=3.0, actor_growth=3.0)
    kw.update(overrides)
    scene = make_synthetic_scene(seed=seed, device=device, **kw)
    params = SceneParams(scene.params_init, scene.pose_params_init, None, None, None)
    with torch.no_grad():
        screen, _ = screen_space(
            params, scene.aux, scene.table, scene.pose_data, scene.frames[frame], 10**9,
            opts=RenderOptions(mode="eval"),
        )
        bi = blend_inputs(screen, kw["H"], kw["W"], config=RasterizeConfig(1024, 2**21))
    return (bi.payload, bi.bins.tile_start, bi.bins.tile_count, bi.num_features,
            bi.grid_x, bi.grid_x * bi.grid_y)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    args = ap.parse_args(argv)
    case = bench_payload(args.device, args.seed)
    payload, _, tile_count = case[:3]
    print(f"payload blocks={payload.shape[0]} c_pad={payload.shape[1]} tiles={case[5]}")
    print(f"instances kept = {int(tile_count.sum())}")
    res = run_probe(*case, iters=args.iters)
    res["device"] = torch.cuda.get_device_name(payload.device) if payload.is_cuda else "cpu"
    print(json.dumps(res))


if __name__ == "__main__":
    main()
