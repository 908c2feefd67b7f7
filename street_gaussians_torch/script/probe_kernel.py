"""Ablation probe of the instance-major tile blend at bench scale.

Counterpart of the JAX package's script/probe_kernel.py. It times the
blend's forward kernel against two variants on the bench frame's payload
(1600x1064, 220,000 background points grown x3, 4 actors, frame 2, eval
mode, instance_capacity 2^21, tile_capacity 1024):

  floor    reads every payload block of every tile's run from a grid of
           one block per tile, with no blend arithmetic (`probe_floor`)
  current  ops/tile_raster2.tile_blend_instances (long runs split into
           segments, one block each)
  variant  the same function, one block per tile, with the in-block
           prefix sums as products with a triangular 0/1 matrix on the
           tensor cores (`probe_blend_mma`)

prints max |current - variant|, and times forward + backward of the
current kernels under the loss sum(out * out) * 1e-6.

    python -m street_gaussians_torch.script.probe_kernel [--iters 20]

Both variants are `csrc/probe_blend.cu`. On a CPU tensor `probe_floor`
runs `probe_floor_plain` and `probe_blend_mma` runs the blend's plain
version, which computes the same function.
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
from street_gaussians_torch.ops.tile_raster2 import CHUNK, PIX

FLOOR_ROWS = 8  # payload rows the floor sums
# feature counts csrc/probe_blend.cu is instantiated for (kernel 2.1 at
# F = 4 is what it ablates)
MAX_FEATURES = 8


def _bind(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.probe_floor, lib.probe_blend_mma):  # tile_blend_fwd's arguments
        fn.argtypes = [p, p, p, p, i, i, i, i, p]
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
    _build.require_cuda(payload, entry)
    if not 1 <= num_features <= MAX_FEATURES:
        raise ValueError(f"{entry}: the kernel takes 1..{MAX_FEATURES} features, got {num_features}")
    payload, tile_start, tile_count = (t.contiguous() for t in (payload, tile_start, tile_count))
    out = torch.empty((num_tiles, PIX, num_features + 1), dtype=torch.float32, device=payload.device)
    fn = getattr(_build.load("probe_blend", _bind), entry)
    err = fn(
        _build.ptr(payload), _build.ptr(tile_start), _build.ptr(tile_count), _build.ptr(out),
        num_tiles, grid_x, payload.shape[1], num_features, _build.stream_of(payload),
    )
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
