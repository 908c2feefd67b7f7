# Port of the repo's root script/kitti/generate_dynamic_mask.py (lines 1-38).
"""KITTI-STEP annotations -> static-region masks for COLMAP.

Reference equivalent: script/kitti/generate_dynamic_mask.py:59-84 —
pixels of movable classes (person/rider/car/truck/bus/train/motorcycle/
bicycle) become 0, everything else 255, i.e. a COLMAP feature-extraction
mask where white = usable (https://colmap.github.io/faq.html).

Usage:
  python -m street_gaussians_torch.script.kitti.generate_dynamic_mask \\
      --annotation_path <kitti_step/panoptic_maps/train/0002> \\
      --output_path <scene>/dynamic_mask
"""

from __future__ import annotations

import numpy as np

from street_gaussians_torch.script.kitti.kitti_step_masks import DYNAMIC_LABELS, run_cli


def dynamic_mask(labels: np.ndarray) -> np.ndarray:
    return np.where(np.isin(labels, DYNAMIC_LABELS), 0, 255).astype(np.uint8)


def main(argv=None):
    return run_cli(__doc__.split("\n\n")[0], dynamic_mask, argv)


if __name__ == "__main__":
    main()
