"""Slow, exact reference rasterizer in plain PyTorch.

Port of street_gaussians_tpu/ops/reference_rasterizer.py. Replicates, per
pixel, the semantics of the CUDA tile renderer
(ref: cuda_rasterizer/forward.cu:340-467):

  * Gaussians are blended front-to-back in view-depth order (a stable
    sort, culled rows last as +inf).
  * A Gaussian contributes to a pixel only if the pixel's tile lies in
    the Gaussian's tile rect (this is what tile binning implies).
  * power = -0.5*(A dx^2 + C dy^2) - B dx dy; skipped if power > 0.
  * alpha = min(0.99, opacity * exp(min(power, 0))); skipped if alpha < 1/255.
  * blending stops (per pixel, sticky) when T*(1-alpha) < 1e-4; the
    triggering Gaussian is NOT blended.
  * outputs: accumulated features (color/depth/semantics), final
    transmittance T.

Differentiable end to end by autograd (the two minimums split a tie's
gradient in half, as jnp.minimum does): the gradient oracle for the tile
kernels. A Python loop over the sorted Gaussians, vectorised over the
pixels, O(pixels x Gaussians): for tests and checks at small sizes only.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from street_gaussians_torch.ops.preprocess import TILE, GaussianScreenData


class RenderOutput(NamedTuple):
    features: torch.Tensor  # [H, W, F] accumulated (premultiplied) features
    transmittance: torch.Tensor  # [H, W] final T


def reference_render(
    screen: GaussianScreenData,
    features: torch.Tensor,
    H: int,
    W: int,
) -> RenderOutput:
    """features: [N, F] per-Gaussian channels (e.g. rgb+depth+semantics)."""
    dev, dt = features.device, features.dtype
    inf = torch.tensor(float("inf"), dtype=screen.depth.dtype, device=dev)
    sort_depth = torch.where(screen.valid, screen.depth, inf)
    order = torch.sort(sort_depth, stable=True).indices

    mean2d = screen.mean2d[order]
    conic = screen.conic[order]
    opacity = screen.opacity[order]
    valid = screen.valid[order].tolist()
    rect_min = screen.rect_min[order]
    rect_max = screen.rect_max[order]
    feats = features[order]

    ys, xs = torch.meshgrid(torch.arange(H, device=dev), torch.arange(W, device=dev), indexing="ij")
    px = xs.to(dt).reshape(-1)  # [P]
    py = ys.to(dt).reshape(-1)
    tile_x = (xs // TILE).reshape(-1)
    tile_y = (ys // TILE).reshape(-1)
    alpha_max = torch.tensor(0.99, dtype=dt, device=dev)
    zero = torch.zeros((), dtype=dt, device=dev)

    P = H * W
    T = torch.ones((P,), dtype=dt, device=dev)
    done = torch.zeros((P,), dtype=torch.bool, device=dev)
    accum = torch.zeros((P, features.shape[-1]), dtype=dt, device=dev)
    for i in range(features.shape[0]):
        if not valid[i]:
            # a culled row blends nowhere (active is all false): T and
            # the sums stay as they are, and no gradient reaches it
            continue
        rmin, rmax = rect_min[i], rect_max[i]
        in_rect = (tile_x >= rmin[0]) & (tile_x < rmax[0]) & (tile_y >= rmin[1]) & (tile_y < rmax[1])
        dx = mean2d[i, 0] - px
        dy = mean2d[i, 1] - py
        con = conic[i]
        power = -0.5 * (con[0] * dx * dx + con[2] * dy * dy) - con[1] * dx * dy
        alpha = torch.minimum(alpha_max, opacity[i] * torch.exp(torch.minimum(power, zero)))
        active = in_rect & (power <= 0.0) & (alpha >= 1.0 / 255.0) & ~done

        test_T = T * (1.0 - alpha)
        trigger = active & (test_T < 1e-4)
        blend = active & ~trigger

        w = torch.where(blend, alpha * T, zero)
        accum = accum + w[:, None] * feats[i][None, :]
        T = torch.where(blend, test_T, T)
        done = done | trigger
    return RenderOutput(features=accum.reshape(H, W, -1), transmittance=T.reshape(H, W))
