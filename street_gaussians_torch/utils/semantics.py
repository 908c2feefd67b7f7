"""Semantic label visualisation and vector quantisation.

Port of street_gaussians_tpu/utils/semantics.py (ref: lib/utils/sem_utils.py:1-56
label colormaps and visualisation, lib/utils/vq_utils.py:1-65
straight-through vector quantisation, an auxiliary capability outside the
main train path). `label_colormap`, `vis_semantic_label` and
`vis_semantic_gt` are numpy, copied from that file; `vq` and
`vq_straight_through` are torch.
"""

from __future__ import annotations

import numpy as np
import torch

from street_gaussians_torch.ops.segsum import segment_rowsum


def label_colormap(n_labels: int = 256) -> np.ndarray:
    """Deterministic label colormap (the PASCAL-VOC bit-shuffle palette
    the reference gets from imgviz). [n, 3] uint8."""

    def bitget(byteval, idx):
        return (byteval >> idx) & 1

    cmap = np.zeros((n_labels, 3), np.uint8)
    for i in range(n_labels):
        r = g = b = 0
        c = i
        for j in range(8):
            r |= bitget(c, 0) << (7 - j)
            g |= bitget(c, 1) << (7 - j)
            b |= bitget(c, 2) << (7 - j)
            c >>= 3
        cmap[i] = [r, g, b]
    return cmap


def vis_semantic_label(semantics: np.ndarray, colormap: np.ndarray | None = None) -> np.ndarray:
    """[H, W, S] logits/probabilities -> [H, W, 3] uint8 color map
    (ref: sem_utils.py:16-26; channels-last here)."""
    labels = np.argmax(np.asarray(semantics), axis=-1)
    cmap = colormap if colormap is not None else label_colormap(semantics.shape[-1] + 1)
    return cmap[labels].astype(np.uint8)


def vis_semantic_gt(semantic_gt: np.ndarray, colormap: np.ndarray | None = None) -> np.ndarray:
    """[H, W] int labels (negative = invalid) -> [H, W, 3] uint8
    (ref: sem_utils.py:29-40)."""
    gt = np.asarray(semantic_gt)
    cmap = colormap if colormap is not None else label_colormap(int(gt.max()) + 2)
    out = np.zeros((*gt.shape, 3), np.uint8)
    valid = gt >= 0
    out[valid] = cmap[gt[valid]]
    return out


# ---------------------------------------------------------------------------
# vector quantization (ref: vq_utils.py, the straight-through estimator)
# ---------------------------------------------------------------------------


def vq(inputs: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """Nearest codebook indices (the first of equal distances). inputs
    [..., D], codebook [K, D] -> [...] int64."""
    flat = inputs.reshape(-1, inputs.shape[-1])
    d = (
        torch.sum(codebook**2, dim=1)[None, :]
        + torch.sum(flat**2, dim=1, keepdim=True)
        - 2.0 * flat @ codebook.T
    )
    return torch.argmin(d, dim=1).reshape(inputs.shape[:-1])


class VQStraightThrough(torch.autograd.Function):
    """codes = codebook[vq(inputs)]; the codes' gradient passes to the
    inputs unchanged, and each codebook row gets the sum of the gradients
    of the codes that chose it: the rows sorted by index (stable) and
    summed in that fixed order by segment_rowsum, no atomics."""

    @staticmethod
    def forward(ctx, inputs, codebook):
        idx = vq(inputs, codebook)
        codes = codebook[idx.reshape(-1)].reshape(inputs.shape)
        ctx.save_for_backward(idx)
        ctx.num_codes = codebook.shape[0]
        ctx.mark_non_differentiable(idx)
        return codes, idx

    @staticmethod
    def backward(ctx, g_codes, _g_idx):
        (idx,) = ctx.saved_tensors
        g_flat = g_codes.reshape(-1, g_codes.shape[-1])
        keys, order = torch.sort(idx.reshape(-1).to(torch.int32), stable=True)
        g_codebook = segment_rowsum(g_flat[order].t().contiguous(), keys, num_segments=ctx.num_codes).t()
        return g_codes, g_codebook.to(g_codes.dtype)


def vq_straight_through(inputs: torch.Tensor, codebook: torch.Tensor):
    """Quantize with a straight-through gradient to the inputs and
    codebook rows (ref: vq_utils.py:33-65). Returns (codes, idx)."""
    return VQStraightThrough.apply(inputs, codebook)
