# Port of the repo's root script/kitti/generate_sky_mask.py (lines 1-36).
"""KITTI-STEP annotations -> sky masks (255 = sky).

Reference equivalent: script/kitti/generate_sky_mask.py (label id 10).
Output format matches what the loader expects (data/waymo.py:
load_sky_mask: nonzero = sky), one PNG per annotation, same relative
paths.

Usage:
  python -m street_gaussians_torch.script.kitti.generate_sky_mask \\
      --annotation_path <kitti_step/panoptic_maps/train/0002> \\
      --output_path <scene>/sky_mask
"""

from __future__ import annotations

import numpy as np

from street_gaussians_torch.script.kitti.kitti_step_masks import SKY_LABEL, run_cli


def sky_mask(labels: np.ndarray) -> np.ndarray:
    return np.where(labels == SKY_LABEL, 255, 0).astype(np.uint8)


def main(argv=None):
    return run_cli(__doc__.split("\n\n")[0], sky_mask, argv)


if __name__ == "__main__":
    main()
