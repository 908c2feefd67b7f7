"""PSNR, SSIM and (where its weights are found) LPIPS of a scene's saved
renders against its ground truth.

    python -m street_gaussians_torch.metrics --config CONFIG.yaml [--device D] [KEY VALUE ...]

runs runner.evaluate_metrics (the JAX package's root metrics.py) and
prints what that prints: one line per split, then one JSON line (LPIPS
in both where utils/lpips.py finds weights).
"""

from __future__ import annotations

import json

from street_gaussians_torch._device import resolve_device
from street_gaussians_torch.config import config_from_args, make_argparser


def main(argv=None):
    ap = make_argparser("street_gaussians_torch metrics")
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    args = ap.parse_args(argv)
    cfg = config_from_args(args)
    cfg.mode = "evaluate"
    from street_gaussians_torch.runner import evaluate_metrics

    results = evaluate_metrics(cfg, device=resolve_device(args.device))
    for split, r in results.items():
        lp = f" LPIPS {r['lpips']:.4f}" if "lpips" in r else ""
        print(f"{split}: PSNR {r['psnr']:.3f} SSIM {r['ssim']:.4f}{lp}")
    print(json.dumps({k: {m: v[m] for m in ("psnr", "ssim", "lpips") if m in v} for k, v in results.items()}))
    return results


if __name__ == "__main__":
    main()
