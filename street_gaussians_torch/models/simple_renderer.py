"""Plain single-cloud 3DGS renderer, the reference's legacy API.

Port of street_gaussians_tpu/models/simple_renderer.py. Reproduces
`GaussianRenderer` (ref: lib/models/gaussian_renderer.py:18-119): render
ONE Gaussian cloud (no scene graph, no actor poses, no sky) for a camera,
with an optional colour override and scale modifier. The composite
pipeline (models/renderer.py) never uses it; it is the smallest entry
point into the rasterizer (e.g. rendering a raw PLY).

Everything is in activated space: linear scales (not log), opacities in
[0, 1], quaternions normalised by the preprocess.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from street_gaussians_torch.ops.preprocess import preprocess_gaussians
from street_gaussians_torch.ops.rasterize import RasterizeConfig, rasterize
from street_gaussians_torch.utils.camera import Camera


def render_gaussians(
    cam: Camera,
    means3d: torch.Tensor,
    scales: torch.Tensor,
    quats: torch.Tensor,
    opacities: torch.Tensor,
    shs: Optional[torch.Tensor] = None,
    colors_precomp: Optional[torch.Tensor] = None,
    sh_degree: int = 3,
    scaling_modifier: float = 1.0,
    bg_color: Optional[torch.Tensor] = None,
    alive: Optional[torch.Tensor] = None,
    extra_features: Optional[torch.Tensor] = None,
    config: RasterizeConfig = RasterizeConfig(),
) -> Dict[str, torch.Tensor]:
    """Render one Gaussian cloud for `cam` (utils/camera.Camera), on the
    device its tensors live on.

    shs: [N, K, 3] band-major SH coefficients, or colors_precomp [N, 3]
    (the reference's override_color path, gaussian_renderer.py:30-36).
    Returns rgb [H,W,3], acc, depth, T, radii [N], visibility [N] bool
    (radii > 0, the densification filter contract of
    gaussian_renderer.py:111-118), the binning counters, and extra
    [H,W,S] when requested."""
    if (shs is None) == (colors_precomp is None):
        raise ValueError("provide exactly one of shs / colors_precomp")
    if bg_color is None:
        bg_color = torch.zeros(3, dtype=means3d.dtype, device=means3d.device)

    screen = preprocess_gaussians(
        means3d=means3d,
        scales=scales,
        quats=quats,
        opacities=opacities,
        shs=shs,
        cam_w2c=cam.w2c,
        cam_full_proj=cam.full_proj,
        cam_center=cam.cam_center,
        H=cam.H,
        W=cam.W,
        focal_x=cam.focal_x,
        focal_y=cam.focal_y,
        tan_fovx=cam.tan_fovx,
        tan_fovy=cam.tan_fovy,
        sh_degree=sh_degree,
        scale_modifier=scaling_modifier,
        alive=alive,
        colors_precomp=colors_precomp,
    )
    out = rasterize(screen, cam.H, cam.W, bg_color, extra_features=extra_features, config=config)
    out["radii"] = screen.radius
    out["visibility"] = screen.radius > 0
    return out
