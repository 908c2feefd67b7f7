"""Visualization: depth and difference colour maps, image dumps and
per-camera videos.

Port of street_gaussians_tpu/visualize.py (ref: lib/visualizers/
base_visualizer.py:13-120, street_gaussian_visualizer.py:12-181,
lib/utils/img_utils.py:242-255) without OpenCV at import: the colour
maps are numpy lookup tables, PNGs go through utils/image_io.py, and
only `write_video` imports cv2 (an mp4 through cv2.VideoWriter, as the
JAX package writes it); it raises where OpenCV is missing.
"""

from __future__ import annotations

import os
from typing import Dict, List

import numpy as np

from street_gaussians_torch.utils.image_io import imwrite

# OpenCV's COLORMAP_JET and COLORMAP_TURBO as cv2.applyColorMap gives
# them for the inputs 0..255 (OpenCV's modules/imgproc/src/colormap.cpp:
# JET linear in 64 control points, TURBO Google's 256-entry turbo
# table, both rounded to uint8 there), in RGB order, 3 bytes an entry;
# tests/test_torch_trajectory.py holds them against cv2.applyColorMap.
_JET_HEX = (
    "00008000008400008800008c00009000009400009800009c0000a00000a40000a80000ac0000b00000b40000b80000bc"
    "0000c00000c40000c80000cc0000d00000d40000d80000dc0000e00000e40000e80000ec0000f00000f40000f80000fc"
    "0000ff0004ff0008ff000cff0010ff0014ff0018ff001cff0020ff0024ff0028ff002cff0030ff0034ff0038ff003cff"
    "0040ff0044ff0048ff004cff0050ff0054ff0058ff005cff0060ff0064ff0068ff006cff0070ff0074ff0078ff007cff"
    "0080ff0084ff0088ff008cff0090ff0094ff0098ff009cff00a0ff00a4ff00a8ff00acff00b0ff00b4ff00b8ff00bcff"
    "00c0ff00c4ff00c8ff00ccff00d0ff00d4ff00d8ff00dcff00e0ff00e4ff00e8ff00ecff00f0ff00f4ff00f8ff00fcff"
    "02fffe06fffa0afff60efff212ffee16ffea1affe61effe222ffde26ffda2affd62effd232ffce36ffca3affc63effc2"
    "42ffbe46ffba4affb64effb252ffae56ffaa5affa65effa262ff9e66ff9a6aff966eff9272ff8e76ff8a7aff867eff82"
    "82ff7e86ff7a8aff768eff7292ff6e96ff6a9aff669eff62a2ff5ea6ff5aaaff56aeff52b2ff4eb6ff4abaff46beff42"
    "c2ff3ec6ff3acaff36ceff32d2ff2ed6ff2adaff26deff22e2ff1ee6ff1aeaff16eeff12f2ff0ef6ff0afaff06feff01"
    "fffc00fff800fff400fff000ffec00ffe800ffe400ffe000ffdc00ffd800ffd400ffd000ffcc00ffc800ffc400ffc000"
    "ffbc00ffb800ffb400ffb000ffac00ffa800ffa400ffa000ff9c00ff9800ff9400ff9000ff8c00ff8800ff8400ff8000"
    "ff7c00ff7800ff7400ff7000ff6c00ff6800ff6400ff6000ff5c00ff5800ff5400ff5000ff4c00ff4800ff4400ff4000"
    "ff3c00ff3800ff3400ff3000ff2c00ff2800ff2400ff2000ff1c00ff1800ff1400ff1000ff0c00ff0800ff0400ff0000"
    "fc0000f80000f40000f00000ec0000e80000e40000e00000dc0000d80000d40000d00000cc0000c80000c40000c00000"
    "bc0000b80000b40000b00000ac0000a80000a40000a000009c00009800009400009000008c0000880000840000800000"
)
_TURBO_HEX = (
    "30123b32154333184a341b51351e5836215f37246638276d392a733a2d793b2f803c32863d358b3e38913f3b973f3e9c"
    "4040a24143a74146ac4249b1424bb5434eba4451bf4454c34456c74559cb455ccf455ed34661d64664da4666dd4669e0"
    "466be3476ee64771e94773eb4776ee4778f0477bf2467df44680f64682f84685fa4687fb458afc458cfd448ffe4391fe"
    "4294ff4196ff4099ff3e9bfe3d9efe3ba0fd3aa3fc38a5fb37a8fa35abf833adf731aff52fb2f42eb4f22cb7f02ab9ee"
    "28bceb27bee925c0e723c3e422c5e220c7df1fc9dd1ecbda1ccdd81bd0d51ad2d21ad4d019d5cd18d7ca18d9c818dbc5"
    "18ddc218dec018e0bd19e2bb19e3b91ae4b61ce6b41de7b21fe9af20eaac22ebaa25eca727eea42aefa12cf09e2ff19b"
    "32f29835f39438f4913cf58e3ff68a43f78746f8844af8804ef97d52fa7a55fa7659fb735dfc6f61fc6c65fd6969fd66"
    "6dfe6271fe5f75fe5c79fe597dff5680ff5384ff5188ff4e8bff4b8fff4992ff4796fe4499fe429cfe409ffd3fa1fd3d"
    "a4fc3ca7fc3aa9fb39acfb38affa37b1f936b4f836b7f735b9f635bcf534bef434c1f334c3f134c6f034c8ef34cbed34"
    "cdec34d0ea34d2e935d4e735d7e535d9e436dbe236dde037dfdf37e1dd37e3db38e5d938e7d739e9d539ebd339ecd13a"
    "eecf3aefcd3af1cb3af2c93af4c73af5c53af6c33af7c13af8be39f9bc39faba39fbb838fbb637fcb336fcb136fdae35"
    "fdac34fea933fea732fea431fea130fe9e2ffe9b2dfe992cfe962bfe932afe9029fd8d27fd8a26fc8725fc8423fb8122"
    "fb7e21fa7b1ff9781ef9751df8721cf76f1af66c19f56918f46617f36315f26014f15d13f05b12ef5811ed5510ec530f"
    "eb500eea4e0de84b0ce7490ce5470be4450ae2430ae14109df3f08dd3d08dc3b07da3907d83706d63506d43305d23105"
    "d02f05ce2d04cc2b04ca2a04c82803c52603c32503c12302be2102bc2002b91e02b71d02b41b01b21a01af1801ac1701"
    "a91601a71401a41301a112019e10019b0f01980e01950d01920b018e0a018b09028808028507028106027e05027a0403"
)
COLORMAPS = {
    "jet": np.frombuffer(bytes.fromhex(_JET_HEX), np.uint8).reshape(256, 3),
    "turbo": np.frombuffer(bytes.fromhex(_TURBO_HEX), np.uint8).reshape(256, 3),
}


def apply_colormap(x: np.ndarray, cmap: str = "jet") -> np.ndarray:
    """uint8 [...] -> RGB uint8 [..., 3]: cv2.applyColorMap(x, cmap)[..., ::-1]."""
    return COLORMAPS[cmap][np.asarray(x, np.uint8)]


def visualize_depth(depth: np.ndarray, minmax=None, cmap="jet"):
    """Depth -> RGB image (ref: img_utils.py:242-255): 2-98 percentile
    normalisation of the valid (> 0) values. Returns (image, (mi, ma))."""
    x = np.nan_to_num(depth)
    if minmax is None:
        valid = x[x > 0]
        mi = np.percentile(valid, 2) if valid.size else 0.0
        ma = np.percentile(valid, 98) if valid.size else 1.0
    else:
        mi, ma = minmax
    x = np.clip((x - mi) / (ma - mi + 1e-8), 0, 1)
    x = (255 * x).astype(np.uint8)
    return apply_colormap(x, cmap), (mi, ma)


def visualize_diff(pred: np.ndarray, gt: np.ndarray, cmap="turbo") -> np.ndarray:
    """Squared-error heat map (ref: base_visualizer.py:42-66)."""
    diff = ((pred - gt) ** 2).sum(axis=-1)
    x = np.clip(diff / max(diff.max(), 1e-8), 0, 1)
    return apply_colormap((255 * x).astype(np.uint8), cmap)


def to_u8(img: np.ndarray) -> np.ndarray:
    return (np.clip(img, 0, 1) * 255).astype(np.uint8)


def save_image(path: str, img: np.ndarray) -> None:
    """An RGB (or gray) float image in [0, 1] as a PNG."""
    imwrite(path, to_u8(img)[..., ::-1] if img.ndim == 3 else to_u8(img))


def write_video(path: str, frames: List[np.ndarray], fps: int = 24) -> None:
    """uint8 RGB frames -> mp4 through cv2.VideoWriter; raises where
    OpenCV is missing (set render.save_video false there)."""
    if not frames:
        return
    try:
        import cv2
    except ImportError as e:
        raise RuntimeError(
            f"writing {path} needs OpenCV (cv2), which is not installed: set render.save_video false"
        ) from e
    h, w = frames[0].shape[:2]
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    for f in frames:
        vw.write(np.ascontiguousarray(f[..., ::-1]))
    vw.release()


class Visualizer:
    """Collects per-frame channels and writes PNGs and videos
    (ref: base_visualizer.py:13-120)."""

    def __init__(self, save_dir: str, save_image: bool = True, save_video: bool = True, fps: int = 24):
        self.dir = save_dir
        os.makedirs(save_dir, exist_ok=True)
        self.save_image = save_image
        self.save_video = save_video
        self.fps = fps
        self.channels: Dict[str, List[np.ndarray]] = {}

    def add(self, name: str, image_name: str, img: np.ndarray) -> None:
        u8 = to_u8(img) if img.dtype != np.uint8 else img
        if self.save_image:
            save_image(os.path.join(self.dir, f"{image_name}_{name}.png"),
                       img if img.dtype != np.uint8 else img / 255.0)
        if self.save_video:
            self.channels.setdefault(name, []).append(u8)

    def summarize(self) -> None:
        if self.save_video:
            for name, frames in self.channels.items():
                write_video(os.path.join(self.dir, f"{name}.mp4"), frames, self.fps)
