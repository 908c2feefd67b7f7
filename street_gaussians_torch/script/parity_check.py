"""Table against instance layout: the two rasterizer paths must render
the same image and the same gradients.

Counterpart of the JAX package's script/tpu_parity_check.py, with its
defaults: an 880x1280 eval render (step 10^9, black background) of frame
2 of the synthetic scene with 150,000 background points grown x3 and 4
actors, tile_capacity 1024, instance_capacity 2^21.

    python -m street_gaussians_torch.script.parity_check [--device cuda]

It rasterizes the preprocessed frame with `layout="table"` and
`layout="instance"`, takes the gradient of sum(rgb) + sum(depth) +
sum(acc) with respect to mean2d, conic, opacity, rgb and depth, and
fails unless rgb, depth and acc agree within 1e-4 and each gradient
within 1e-3 * max(largest |table gradient|, 1). The layouts hold the same
contributors only when neither drops an instance, so zero overflow is
required of both; when a tile holds more than tile_capacity Gaussians
the capacity is raised to the next multiple of 128 that holds the
largest tile. It prints forward and forward+backward ms per layout (CUDA
events on a card, the host clock on the CPU).
"""

from __future__ import annotations

import argparse
import json
from typing import Callable, Dict

import torch

from street_gaussians_torch._device import resolve_device, time_ms
from street_gaussians_torch.data.synthetic import make_synthetic_scene
from street_gaussians_torch.models.renderer import RenderOptions, SceneParams, screen_space
from street_gaussians_torch.ops.binning import bin_gaussians_instances
from street_gaussians_torch.ops.preprocess import GaussianScreenData
from street_gaussians_torch.ops.rasterize import RasterizeConfig, _grid_dims, rasterize
from street_gaussians_torch.ops.tile_raster2 import CHUNK

FWD_TOL = 1e-4
GRAD_TOL = 1e-3
LAYOUTS = ("table", "instance")
GRAD_LEAVES = ("mean2d", "conic", "opacity", "rgb", "depth")


def largest_tile_count(screen: GaussianScreenData, H: int, W: int, instance_capacity: int) -> int:
    """The most Gaussians any tile lists when nothing is culled or capped."""
    grid_x, grid_y = _grid_dims(H, W)
    bins = bin_gaussians_instances(
        screen, grid_x, grid_y, instance_capacity, instance_capacity, corner_cull=False
    )
    return int(bins.tile_count.max())


def compare_layouts(
    screen: GaussianScreenData,
    H: int,
    W: int,
    tile_capacity: int = 1024,
    instance_capacity: int = 2**21,
    iters: int = 10,
    log: Callable[[str], None] = print,
) -> Dict:
    """Rasterize `screen` with both layouts, forward and gradients, and
    raise AssertionError unless they agree (see the module docstring).
    Returns the differences, the times and the sizes."""
    dev = screen.depth.device
    screen = GaussianScreenData(*[t.detach() for t in screen])
    bg = torch.zeros(3, device=dev)
    max_count = largest_tile_count(screen, H, W, instance_capacity)
    if max_count > tile_capacity:
        raised = -(-max_count // CHUNK) * CHUNK
        log(f"[parity] largest tile holds {max_count} > tile_capacity {tile_capacity}: raised to {raised}")
        tile_capacity = raised
    configs = {
        layout: RasterizeConfig(tile_capacity, instance_capacity, layout=layout) for layout in LAYOUTS
    }
    res = {"tile_capacity": tile_capacity, "max_tile_count": max_count,
           "fwd_ms": {}, "fwd_bwd_ms": {}, "max_abs_diff": {}, "grad": {}}

    outs = {}
    for layout, cfg in configs.items():
        with torch.no_grad():
            fwd = lambda: rasterize(screen, H, W, bg, config=cfg)  # noqa: E731
            outs[layout] = fwd()
            res["fwd_ms"][layout] = time_ms(fwd, iters, dev)
        if int(outs[layout]["overflow"]) != 0:
            raise AssertionError(f"{layout}: {int(outs[layout]['overflow'])} instances dropped")
        log(f"{layout} fwd: {res['fwd_ms'][layout]:.3f} ms")
    res["num_instances"] = int(outs["table"]["num_instances"])
    log(f"[parity] {res['num_instances']} instances, largest tile {max_count}, tile_capacity {tile_capacity}")
    for k in ("rgb", "depth", "acc"):
        d = float((outs["table"][k] - outs["instance"][k]).abs().max())
        res["max_abs_diff"][k] = d
        log(f"max|d{k}| = {d:.2e}")
        if not d < FWD_TOL:
            raise AssertionError(f"{k}: layouts differ by {d} (limit {FWD_TOL})")
    del outs

    grads = {}
    for layout, cfg in configs.items():
        def fwd_bwd():
            leaves = [getattr(screen, name).clone().requires_grad_(True) for name in GRAD_LEAVES]
            o = rasterize(screen._replace(**dict(zip(GRAD_LEAVES, leaves))), H, W, bg, config=cfg)
            loss = o["rgb"].sum() + o["depth"].sum() + o["acc"].sum()
            return torch.autograd.grad(loss, leaves)

        grads[layout] = fwd_bwd()
        res["fwd_bwd_ms"][layout] = time_ms(fwd_bwd, iters, dev)
        log(f"{layout} fwd+bwd: {res['fwd_bwd_ms'][layout]:.3f} ms")
    for name, a, b in zip(GRAD_LEAVES, grads["table"], grads["instance"]):
        d = float((a - b).abs().max())
        scale = float(a.abs().max())
        res["grad"][name] = {"max_abs_diff": d, "scale": scale}
        log(f"grad {name}: max|diff| {d:.3e} (scale {scale:.3e})")
        if not d < GRAD_TOL * max(scale, 1.0):
            raise AssertionError(f"grad {name}: layouts differ by {d} at scale {scale}")
    log("TABLE/INSTANCE PARITY OK")
    return res


def parity_check(
    device=None,
    H: int = 880,
    W: int = 1280,
    num_bkgd: int = 150_000,
    num_actors: int = 4,
    growth: float = 3.0,
    frame: int = 2,
    seed: int = 0,
    tile_capacity: int = 1024,
    instance_capacity: int = 2**21,
    iters: int = 10,
    log: Callable[[str], None] = print,
) -> Dict:
    """Build the synthetic scene on `device` (default: the CUDA card;
    raises without one), preprocess `frame` in eval mode and compare the
    layouts on it."""
    device = resolve_device(device)
    # full float32 products, as the JAX code's precision="highest"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    scene = make_synthetic_scene(
        num_bkgd=num_bkgd, num_actors=num_actors, H=H, W=W, seed=seed, device=device,
        background_growth=growth, actor_growth=growth,
    )
    params = SceneParams(scene.params_init, scene.pose_params_init, None, None, None)
    with torch.no_grad():
        screen, _ = screen_space(
            params, scene.aux, scene.table, scene.pose_data, scene.frames[frame], 10**9,
            opts=RenderOptions(mode="eval"),
        )
    res = compare_layouts(screen, H, W, tile_capacity, instance_capacity, iters, log)
    res["device"] = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    res["capacity"] = scene.table.capacity
    return res


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    print(json.dumps(parity_check(args.device, iters=args.iters, seed=args.seed)))


if __name__ == "__main__":
    main()
