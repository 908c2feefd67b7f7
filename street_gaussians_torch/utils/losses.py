"""Image losses: masked L1/L2, PSNR, SSIM, binary cross-entropy.

Port of street_gaussians_tpu/utils/losses.py. Images are [H, W, C].
Bounds that the JAX code takes with jnp.maximum / jnp.clip go through
torch.maximum / torch.minimum, which split a tie's gradient the same way
(torch.clamp would give it all to the input); |x| has JAX's derivative
+1 at 0 (torch's is 0), which matters where the render equals the
target exactly.
"""

from __future__ import annotations

from typing import Optional

import torch

from street_gaussians_torch.utils.trace import span


def _bound(v, x: torch.Tensor) -> torch.Tensor:
    # a Python float copied to the card waits on the stream
    with span("sync/clip_bounds"):
        return torch.as_tensor(v, dtype=x.dtype, device=x.device)


def jnp_maximum(x: torch.Tensor, lo) -> torch.Tensor:
    """max(x, lo) with jnp.maximum's gradient: half to each side at a tie."""
    return torch.maximum(x, _bound(lo, x))


def jnp_clip(x: torch.Tensor, lo, hi) -> torch.Tensor:
    """jnp.clip: maximum, then minimum, with their tie gradients."""
    return torch.minimum(jnp_maximum(x, lo), _bound(hi, x))


def jnp_abs(x: torch.Tensor) -> torch.Tensor:
    """|x| with jnp.abs's gradient: +1 at 0."""
    return torch.where(x >= 0, x, -x)


def _masked_mean(v: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    if mask is None:
        return v.mean()
    m = torch.broadcast_to(mask, v.shape).to(v.dtype)
    return (v * m).sum() / jnp_maximum(m.sum(), 1.0)


def l1_loss(pred, gt, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean |pred - gt|; with a mask broadcastable to them, over the
    masked elements only."""
    return _masked_mean(jnp_abs(pred - gt), mask)


def l2_loss(pred, gt, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    return _masked_mean((pred - gt) ** 2, mask)


def psnr(pred, gt, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    return -10.0 * torch.log10(jnp_maximum(l2_loss(pred, gt, mask), 1e-12))


def _gaussian_window(window_size: int, sigma: float, device) -> torch.Tensor:
    x = torch.arange(window_size, dtype=torch.float32, device=device) - window_size // 2
    g = torch.exp(-(x**2) / (2.0 * sigma**2))
    return g / g.sum()


def _band(n: int, win: torch.Tensor) -> torch.Tensor:
    """[n, n] banded matrix B[i, j] = win[j - i + half]: x @ B is the
    SAME-padded 1-D window convolution."""
    half = win.shape[0] // 2
    idx = torch.arange(n, device=win.device)
    d = idx[None, :] - idx[:, None]
    w = win[torch.clamp(d + half, 0, win.shape[0] - 1)]
    return torch.where(d.abs() <= half, w, 0.0)


def ssim(
    pred: torch.Tensor, gt: torch.Tensor, window_size: int = 11, mask: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """SSIM with an 11x11 gaussian window, sigma 1.5, SAME padding, as
    two banded matrix products per blur (f32; the caller keeps TF32
    off). With a mask, out-of-mask pixels are zeroed before the blurs and
    the mean runs over all pixels. The variances are clamped at 0 and the
    covariance bounded by Cauchy-Schwarz (no gradient through the bound):
    E[x^2] - mu^2 cancels in f32 on flat patches and can go negative."""
    if mask is not None:
        m = torch.broadcast_to(mask, pred.shape)
        pred = torch.where(m, pred, 0.0)
        gt = torch.where(m, gt, 0.0)
    H, W = pred.shape[0], pred.shape[1]
    win = _gaussian_window(window_size, 1.5, pred.device)
    Bw = _band(W, win)
    Bh = _band(H, win)

    def conv(img):
        x = img.permute(2, 0, 1) @ Bw  # [C, H, W]
        x = x.transpose(1, 2) @ Bh  # [C, W, H]
        return x.permute(2, 1, 0)  # [H, W, C]

    mu1 = conv(pred)
    mu2 = conv(gt)
    mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = jnp_maximum(conv(pred * pred) - mu1_sq, 0.0)
    sigma2_sq = jnp_maximum(conv(gt * gt) - mu2_sq, 0.0)
    sigma12 = conv(pred * gt) - mu12
    bound = torch.sqrt(sigma1_sq * sigma2_sq + 1e-12).detach()
    sigma12 = torch.minimum(torch.maximum(sigma12, -bound), bound)
    c1 = 0.01**2
    c2 = 0.03**2
    ssim_map = ((2.0 * mu12 + c1) * (2.0 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2)
    )
    return ssim_map.mean()


def binary_cross_entropy(pred, target, eps: float = 1e-4) -> torch.Tensor:
    """Plain BCE on probabilities."""
    p = jnp_clip(pred, eps, 1.0 - eps)
    return -(target * torch.log(p) + (1.0 - target) * torch.log(1.0 - p)).mean()


def entropy_loss(p, mask: Optional[torch.Tensor] = None, eps: float = 1e-4) -> torch.Tensor:
    """Binary entropy of probabilities, masked mean."""
    p = jnp_clip(p, eps, 1.0 - eps)
    return _masked_mean(-(p * torch.log(p) + (1.0 - p) * torch.log(1.0 - p)), mask)
