"""Render the splits of a trained scene from its newest checkpoint.

    python -m street_gaussians_torch.render --config CONFIG.yaml [--device D] [KEY VALUE ...]

runs runner.render_sets (the JAX package's root render.py, mode
evaluate): test_renders/ and train_renders/ PNGs under model_path, the
mean ms per view and the pipelined frames per second. `--mode
trajectory` (the per-channel videos) is not ported yet.
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
    if mode == "trajectory":
        raise NotImplementedError(
            "render mode trajectory (runner.render_trajectory and its videos) is not ported to "
            "street_gaussians_torch yet (ROADMAP.md queue 1, item 4)")
    from street_gaussians_torch.runner import render_sets

    return render_sets(cfg, device=resolve_device(args.device))


if __name__ == "__main__":
    main()
