"""LPIPS perceptual metric.

Port of street_gaussians_tpu/utils/lpips.py (the reference's vendored
lpipsPyTorch, ref: lib/utils/lpipsPyTorch/modules/lpips.py:1-36,
networks.py:36-90, utils.py:6-9): z-score the inputs with the LPIPS
shift and scale, run the AlexNet (or VGG16) feature stack, unit-normalise
each target activation over its channels, square the difference, weight
the channels by the calibrated 1x1 "lin" convolutions, average over the
pixels and sum over the layers. Images are in [0, 1], as the reference
feeds them (metrics.py:81). The stacks are torch.nn.functional.conv2d /
max_pool2d / relu on the device of the inputs, in full float32 (cuDNN's
TF32 is turned off for the call).

The weights do not ship with the repository and nothing downloads them.
They load, as in the JAX package, from

  1. `$SGTPU_LPIPS_WEIGHTS`: an .npz with keys `<net>.conv<i>.weight`,
     `<net>.conv<i>.bias`, `<net>.lin<l>.weight` (the JAX package's
     `script/export_lpips_weights.py` writes one), or
  2. the torch hub cache (~/.cache/torch/hub/checkpoints/): a
     torchvision backbone (`alexnet*.pth`, `vgg16*.pth`) and the LPIPS
     lin weights (`alex.pth` / `vgg.pth`, or `lpips_alex.pth` /
     `lpips_vgg.pth`).

Without them `lpips()` returns None and the metrics report PSNR and SSIM
alone: an uncalibrated stand-in is not LPIPS.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as Fn

# LPIPS scaling layer constants (networks.py:41-44)
_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)

# AlexNet feature stack (torchvision models.alexnet().features):
# (kind, out_ch, kernel, stride, pad) per conv; "pool" = max pool k3 s2.
# The targets are the five post-ReLU maps (networks.py:81-83), counted
# from 1 over the modules.
_ALEX_ARCH = [
    ("conv", 64, 11, 4, 2), ("relu",), ("pool",),
    ("conv", 192, 5, 1, 2), ("relu",), ("pool",),
    ("conv", 384, 3, 1, 1), ("relu",),
    ("conv", 256, 3, 1, 1), ("relu",),
    ("conv", 256, 3, 1, 1), ("relu",),
]
_ALEX_TARGETS = (2, 5, 8, 10, 12)
_ALEX_CHANNELS = (64, 192, 384, 256, 256)

# VGG16 features (networks.py:85-90): every conv k3 s1 p1, "vpool" = k2 s2
_VGG_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M", 512, 512, 512]
_VGG_TARGETS = (4, 9, 16, 23, 30)
_VGG_CHANNELS = (64, 128, 256, 512, 512)


def _vgg_arch():
    arch = []
    for v in _VGG_CFG:
        if v == "M":
            arch.append(("vpool",))
        else:
            arch += [("conv", v, 3, 1, 1), ("relu",)]
    return arch


def _arch(net_type: str):
    if net_type == "alex":
        return _ALEX_ARCH, _ALEX_TARGETS
    if net_type == "vgg":
        return _vgg_arch(), _VGG_TARGETS
    raise ValueError(net_type)


def _features(x: torch.Tensor, arch, targets, weights: Dict[str, torch.Tensor]) -> list:
    """x: [N, 3, H, W] in [0, 1]. The channel-normalised target
    activations."""
    shift = torch.as_tensor(_SHIFT, device=x.device)[None, :, None, None]
    scale = torch.as_tensor(_SCALE, device=x.device)[None, :, None, None]
    x = (x - shift) / scale
    outputs = []
    conv_i = 0
    for i, layer in enumerate(arch, 1):
        kind = layer[0]
        if kind == "conv":
            _, _, _, s, p = layer
            x = Fn.conv2d(x, weights[f"conv{conv_i}.weight"], weights[f"conv{conv_i}.bias"], stride=s, padding=p)
            conv_i += 1
        elif kind == "relu":
            x = torch.clamp(x, min=0.0)
        elif kind == "pool":
            x = Fn.max_pool2d(x, 3, 2)
        elif kind == "vpool":
            x = Fn.max_pool2d(x, 2, 2)
        if i in targets:
            norm = torch.sqrt(torch.sum(x * x, dim=1, keepdim=True))
            outputs.append(x / (norm + 1e-10))  # utils.py:6-9
        if len(outputs) == len(targets):
            break
    return outputs


def _on_device(weights: Dict, device) -> Dict[str, torch.Tensor]:
    """float32 tensors on `device` (no copy for those already there)."""
    return {k: torch.as_tensor(v, dtype=torch.float32, device=device) for k, v in weights.items()}


def lpips_from_weights(pred, gt, weights: Dict, net_type: str = "alex") -> torch.Tensor:
    """LPIPS of pred against gt ([H, W, 3] in [0, 1], tensors or arrays;
    computed on the device of a tensor `pred`, else the CPU) with the
    given weights (name -> array or tensor). Returns a 0-dim tensor."""
    arch, targets = _arch(net_type)
    device = pred.device if torch.is_tensor(pred) else torch.device("cpu")

    def prep(im):
        return torch.as_tensor(im, dtype=torch.float32, device=device).permute(2, 0, 1)[None]

    w = _on_device(weights, device)
    with torch.no_grad(), torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        fx = _features(prep(pred), arch, targets, w)
        fy = _features(prep(gt), arch, targets, w)
        total = torch.zeros((), dtype=torch.float32, device=device)
        for li, (a, b) in enumerate(zip(fx, fy)):
            d = (a - b) ** 2
            lin = w[f"lin{li}.weight"]  # [1, C, 1, 1]
            # the 1x1 conv (no bias), the pixel mean, the sum over layers (lpips.py:33-36)
            layer = torch.sum(d * lin[0, :, 0, 0][None, :, None, None], dim=1)
            total = total + torch.mean(layer)
    return total


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------

_cache: Dict[str, Optional[Dict[str, np.ndarray]]] = {}


def _hub_dir() -> str:
    return os.path.join(os.path.expanduser("~"), ".cache", "torch", "hub", "checkpoints")


def load_weights(net_type: str = "alex") -> Optional[Dict[str, np.ndarray]]:
    """Backbone and lin weights (name -> array), or None."""
    if net_type in _cache:
        return _cache[net_type]
    w = _load_npz(net_type) or _load_torch(net_type)
    _cache[net_type] = w
    return w


def _load_npz(net_type):
    path = os.environ.get("SGTPU_LPIPS_WEIGHTS")
    if not path or not os.path.exists(path):
        return None
    try:
        data = dict(np.load(path))
    except Exception:
        return None
    prefix = f"{net_type}."
    sel = {k[len(prefix):]: v for k, v in data.items() if k.startswith(prefix)}
    return sel or None


def _load_torch(net_type):
    """The torch hub cache: a torchvision backbone .pth and the LPIPS lin
    .pth, under either naming scheme."""
    hub = _hub_dir()
    if not os.path.isdir(hub):
        return None
    backbone_tag = {"alex": "alexnet", "vgg": "vgg16"}[net_type]
    backbone = lin = None
    for fn in sorted(os.listdir(hub)):
        p = os.path.join(hub, fn)
        if fn.startswith(backbone_tag) and fn.endswith(".pth"):
            backbone = torch.load(p, map_location="cpu", weights_only=True)
        if fn in (f"{net_type}.pth", f"lpips_{net_type}.pth"):
            lin = torch.load(p, map_location="cpu", weights_only=True)
    if backbone is None or lin is None:
        return None
    out = {}
    conv_i = 0
    # torchvision state dicts name the convs features.<idx>.weight
    idxs = sorted({int(k.split(".")[1]) for k in backbone if k.startswith("features.")})
    for idx in idxs:
        wk, bk = f"features.{idx}.weight", f"features.{idx}.bias"
        if wk in backbone:
            out[f"conv{conv_i}.weight"] = backbone[wk].numpy()
            out[f"conv{conv_i}.bias"] = backbone[bk].numpy()
            conv_i += 1
    for li in range(5):
        for key in (f"lin{li}.model.1.weight", f"{li}.1.weight", f"lin{li}.weight"):
            if key in lin:
                out[f"lin{li}.weight"] = np.asarray(lin[key])
                break
    if "lin4.weight" not in out:
        return None
    return out


def lpips(pred, gt, net_type: str = "alex") -> Optional[float]:
    """LPIPS of pred against gt ([H, W, 3] in [0, 1]) on the device of a
    tensor `pred`, or None when no calibrated weights are found (see the
    module docstring)."""
    w = load_weights(net_type)
    if w is None:
        return None
    return float(lpips_from_weights(pred, gt, w, net_type))
