# Port of the repo's root script/kitti/generate_semantic_mask.py (lines 1-33).
"""KITTI-STEP annotations -> cityscapes-colormapped semantic PNGs.

Reference equivalent: script/kitti/generate_semantic_mask.py (same
colormap, vectorized instead of a per-pixel python loop).

Usage:
  python -m street_gaussians_torch.script.kitti.generate_semantic_mask \\
      --annotation_path <kitti_step/panoptic_maps/train/0002> \\
      --output_path <scene>/semantic
"""

from __future__ import annotations

import numpy as np

from street_gaussians_torch.script.kitti.kitti_step_masks import COLORMAP, run_cli


def semantic_image(labels: np.ndarray) -> np.ndarray:
    """[H, W, 3] BGR, the order imwrite (as cv2.imwrite) takes."""
    return COLORMAP[labels][..., ::-1]


def main(argv=None):
    return run_cli(__doc__.split("\n\n")[0], semantic_image, argv)


if __name__ == "__main__":
    main()
