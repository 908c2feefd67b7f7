# Port of the repo's root script/kitti/kitti_step_masks.py (lines 1-52), PNGs read
# and written by utils/image_io in place of cv2.
"""Shared KITTI-STEP annotation decoding for the mask scripts.

KITTI-STEP panoptic PNGs encode the semantic class id in the RED
channel (ref: script/kitti/generate_dynamic_mask.py:77 reads
`img[..., 2]` from a cv2 BGR load). Class table (ref:
generate_dynamic_mask.py:12-32): 0 road, 1 sidewalk, 2 building,
3 wall, 4 fence, 5 pole, 6 traffic light, 7 traffic sign,
8 vegetation, 9 terrain, 10 sky, 11 person, 12 rider, 13 car,
14 truck, 15 bus, 16 train, 17 motorcycle, 18 bicycle, 255 void.
"""

from __future__ import annotations

import os
from glob import glob

import numpy as np

from street_gaussians_torch.utils.image_io import imread, imwrite

SKY_LABEL = 10
# movable classes (ref: generate_dynamic_mask.py:59)
DYNAMIC_LABELS = np.array([11, 12, 13, 14, 15, 16, 17, 18], np.uint8)

# cityscapes colormap, RGB (ref: generate_dynamic_mask.py:36-55)
COLORMAP = np.zeros((256, 3), np.uint8)
for _i, _c in enumerate(
    [
        (128, 64, 128), (244, 35, 232), (70, 70, 70), (102, 102, 156),
        (190, 153, 153), (153, 153, 153), (70, 130, 180), (220, 220, 0),
        (107, 142, 35), (152, 251, 152), (250, 170, 30), (220, 20, 60),
        (255, 0, 0), (0, 0, 142), (0, 0, 70), (0, 60, 100), (0, 80, 100),
        (0, 0, 230), (119, 11, 32),
    ]
):
    COLORMAP[_i] = _c


def read_labels(path: str) -> np.ndarray:
    """Load a KITTI-STEP annotation PNG -> [H, W] uint8 semantic ids."""
    img = imread(path)
    return img[..., 2].astype(np.uint8)  # R channel of the BGR load


def iter_annotations(annotation_path: str):
    files = sorted(glob(os.path.join(annotation_path, "**", "*.png"), recursive=True))
    for fn in files:
        yield os.path.relpath(fn, annotation_path), read_labels(fn)


def write_png(out_path: str, img: np.ndarray):
    """cv2.imwrite of a gray or BGR image."""
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    imwrite(out_path, img)


def run_cli(description: str, to_image, argv=None) -> list:
    """The three mask scripts' CLI: every annotation PNG under
    --annotation_path through to_image(labels) into the same relative
    path under --output_path. Returns the paths written."""
    import argparse

    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--annotation_path", required=True)
    ap.add_argument("--output_path", required=True)
    args = ap.parse_args(argv)
    written = []
    for rel, labels in iter_annotations(args.annotation_path):
        out = os.path.join(args.output_path, rel)
        write_png(out, to_image(labels))
        print(out)
        written.append(out)
    return written
