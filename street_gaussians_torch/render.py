"""Render the splits of a trained scene from its newest checkpoint.

    python -m street_gaussians_torch.render --config CONFIG.yaml [--device D] [KEY VALUE ...]

runs runner.render_sets (the JAX package's root render.py, mode
evaluate): test_renders/ and train_renders/ PNGs under model_path, the
mean ms per view and the pipelined frames per second. With `--mode
trajectory` it runs runner.render_trajectory: every view in frame order
(render.concat_cameras picks the cameras), the channels rgb, object,
background, depth and acc under model_path/trajectory/ as PNGs and, with
render.save_video (the default, which needs OpenCV), one mp4 a channel.
"""

from __future__ import annotations

from street_gaussians_torch._device import resolve_device
from street_gaussians_torch.config import config_from_args, make_argparser


def main(argv=None):
    ap = make_argparser("street_gaussians_torch renderer")
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    args = ap.parse_args(argv)
    cfg = config_from_args(args)
    mode = cfg.mode if cfg.mode in ("evaluate", "trajectory") else "evaluate"
    cfg.mode = "evaluate"
    from street_gaussians_torch.runner import render_sets, render_trajectory

    if mode == "trajectory":
        return render_trajectory(cfg, device=resolve_device(args.device))
    return render_sets(cfg, device=resolve_device(args.device))


if __name__ == "__main__":
    main()
