# Port of the repo's root script/waymo/generate_sky_mask.py (lines 1-87): the
# gradient heuristic in numpy/scipy in place of cv2's morphologyEx and
# connectedComponents, images through utils/image_io; the ONNX backend is not
# ported (it raises, naming the model it needs).
"""Sky segmentation masks for a converted Waymo sequence.

The reference uses GroundingDINO + SAM checkpoints for this step
(ref: script/waymo/generate_sky_mask.py:1-190) — multi-GB pretrained
models that cannot ship with the framework. This port keeps the root
script's CLI (less --sky_class, which only the ONNX backend would read)
and output contract (`sky_mask/{frame:06d}_{cam}.png`, white = sky) with
its classical backend:

  * --backend gradient (the default): flood-fill from the top image rows
    over a brightness/blue-dominance prior. Crude but unblocks the
    sky-loss path when no checkpoints are available.
  * --backend onnx: the root script's segmentation-model backend needs an
    ONNX model file (--onnx_model, e.g. an exported SegFormer with an
    ADE20k sky class) and onnxruntime; the repository ships neither, so
    the port raises and names the file it would need.

Usage:
  python -m street_gaussians_torch.script.waymo.generate_sky_mask --datadir <seq_dir>

Pixel for pixel the root script's masks: cv2's 7x7 closing ignores the
image border (morphologyDefaultBorderValue), which grey_dilation then
grey_erosion with mode="nearest" reproduce (a clamped window coordinate
stays inside the window); cv2.connectedComponents' 8-connectivity is
scipy.ndimage.label with a 3x3 structure (other label numbers, the same
components). Host numpy.
"""

from __future__ import annotations

import argparse
import os
import time
from glob import glob

import numpy as np
from scipy import ndimage

from street_gaussians_torch.utils.image_io import imread, imwrite

CLOSE_SIZE = (7, 7)
EIGHT_CONNECTED = np.ones((3, 3), bool)


def gradient_sky_mask(img: np.ndarray) -> np.ndarray:
    """Classical heuristic: bright/blue-ish regions connected to the top
    border. img: BGR uint8 [H, W, 3] (cv2's order) -> uint8 [H, W], 255
    where sky."""
    h, w = img.shape[:2]
    b, g, r = img[..., 0].astype(int), img[..., 1].astype(int), img[..., 2].astype(int)
    brightness = (b + g + r) / 3.0
    blueish = b >= r - 10
    candidate = (((brightness > 110) & blueish) | (brightness > 200)).astype(np.uint8)
    # cv2.morphologyEx(MORPH_CLOSE, ones(7, 7)): dilate then erode, the
    # border never taking part
    closed = ndimage.grey_dilation(candidate, size=CLOSE_SIZE, mode="nearest")
    closed = ndimage.grey_erosion(closed, size=CLOSE_SIZE, mode="nearest")
    # keep only components touching the top 5% of the image
    labels, _ = ndimage.label(closed, structure=EIGHT_CONNECTED)
    top = np.unique(labels[: max(h // 20, 1)])
    mask = np.isin(labels, top[top != 0])
    return (mask * 255).astype(np.uint8)


def generate_sky_masks(datadir: str, backend: str = "gradient", onnx_model=None) -> dict:
    """Write sky_mask/<image>.png for every image of datadir. Returns the
    seconds it took and the images written."""
    if backend == "onnx":
        raise NotImplementedError(
            f"--backend onnx needs a segmentation model with a sky class exported to ONNX "
            f"(--onnx_model {onnx_model or '<model.onnx>'}, e.g. SegFormer on ADE20k, sky class 2) and "
            "onnxruntime; the repository ships no such model and the port does not run one. "
            "Use --backend gradient.")
    if backend != "gradient":
        raise ValueError(f"backend {backend!r}: 'gradient' or 'onnx'")
    t0 = time.perf_counter()
    save_dir = os.path.join(datadir, "sky_mask")
    os.makedirs(save_dir, exist_ok=True)
    files = sorted(
        glob(os.path.join(datadir, "images", "*.png"))
        + glob(os.path.join(datadir, "images", "*.jpg"))
    )
    for fn in files:
        mask = gradient_sky_mask(imread(fn))
        imwrite(os.path.join(save_dir, os.path.basename(fn).split(".")[0] + ".png"), mask)
    print(f"wrote {len(files)} sky masks to {save_dir} (backend={backend})")
    return {"seconds": time.perf_counter() - t0, "images": len(files)}


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--datadir", required=True)
    parser.add_argument("--backend", choices=["gradient", "onnx"], default="gradient")
    parser.add_argument("--onnx_model", default=None)
    args = parser.parse_args(argv)
    return generate_sky_masks(args.datadir, args.backend, args.onnx_model)


if __name__ == "__main__":
    main()
