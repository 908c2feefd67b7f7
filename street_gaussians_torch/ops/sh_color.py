"""The view-dependent colour of every Gaussian: its SH coefficients
(the Fourier DC of its time for an actor's row, coefficient 0 for the
background's, the bands above the row's active degree masked) along the
camera -> mean direction, + 0.5, clamped at 0.

Replaces no TPU kernel: the JAX package computes the colour in plain
jnp (street_gaussians_tpu/models/renderer.py compose_frame's Fourier DC,
band mask and coefficient table; ops/preprocess.py's basis and
product), which XLA fuses. Run eagerly, that is some 50 elementwise,
stack, cat and batched-gemv kernels forward and as many VJPs backward
over [C, K, 3] tables.

`sh_color` runs the plain version (`sh_color_plain`, the same eager
PyTorch that compose_frame and preprocess_gaussians ran) for CPU
tensors, and for CUDA tensors
`csrc/sh_color.cu`: one launch forward, one backward (an autograd
Function whose backward recomputes each row from the inputs and saves
no [C, K] or [C, K, 3] tensor; see the source for its bound and
design). The kernel takes float32 tensors (copied to contiguous where
they are not), a bool `is_actor` and K in {1, 4, 9, 16}; it raises on
anything else. Counters: `sh_color.launches` (forward) and
`sh_color.bwd_launches`.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional

import torch

from street_gaussians_torch.kernels import _build
from street_gaussians_torch.utils import sh as sh_utils
from street_gaussians_torch.utils.trace import span


class ShInputs(NamedTuple):
    """A render's SH coefficients as the parameters hold them, and what
    selects and masks them a row."""

    feat_dc: torch.Tensor  # [C, F, 3] Fourier DC coefficients (F = 1: the plain DC)
    feat_rest: torch.Tensor  # [C, K-1, 3] the higher bands, band-major
    t_row: Optional[torch.Tensor]  # [C] float: an actor row's Fourier time (None: 0)
    is_actor: Optional[torch.Tensor]  # [C] bool; None: no actor rows
    deg_bkgd: int  # the active degree of a background row
    deg_obj: int  # the active degree of an actor row


def inputs_from_table(shs: torch.Tensor, sh_degree: int) -> ShInputs:
    """ShInputs of one cloud's [N, K, 3] coefficient table at sh_degree."""
    return ShInputs(shs[:, :1], shs[:, 1:], None, None, sh_degree, sh_degree)


def sh_table(feat_dc, feat_rest, t_row, is_actor, deg_bkgd: int, deg_obj: int) -> torch.Tensor:
    """The [C, K, 3] coefficient table the colour evaluates: the row's DC
    (an actor's Fourier DC at t_row, a background row's coefficient 0)
    and the bands up to its active degree (the rest masked to 0)."""
    C, F = feat_dc.shape[:2]
    K = feat_rest.shape[1] + 1
    dev = feat_dc.device
    if is_actor is None:
        is_actor = torch.zeros(C, dtype=torch.bool, device=dev)
    if t_row is None:
        t_row = torch.zeros(C, dtype=torch.float32, device=dev)
    basis = sh_utils.idft_basis(t_row, F)  # [C, F]
    # background rows use only coefficient 0
    bkgd_basis = torch.zeros_like(basis)
    bkgd_basis[:, 0] = 1.0
    basis = torch.where(is_actor[:, None], basis, bkgd_basis)
    dc = torch.einsum("cf,cfk->ck", basis, feat_dc)  # [C, 3]
    deg_row = torch.where(is_actor, deg_obj, deg_bkgd)  # [C]
    band = torch.floor(torch.sqrt(torch.arange(1, K, dtype=torch.float32, device=dev))).to(torch.int64)
    rest_mask = (band[None, :] <= deg_row[:, None]).to(torch.float32)  # [C, K-1]
    rest = feat_rest * rest_mask[..., None]
    return torch.cat([dc[:, None, :], rest], dim=1)


def sh_color_plain(means3d, cam_center, feat_dc, feat_rest, t_row, is_actor, deg_bkgd: int,
                   deg_obj: int) -> torch.Tensor:
    """Plain PyTorch version: rgb [C, 3]. Same contract as `sh_color`."""
    shs = sh_table(feat_dc, feat_rest, t_row, is_actor, deg_bkgd, deg_obj)
    deg = min(max(deg_bkgd, deg_obj), math.isqrt(shs.shape[1]) - 1)
    dirs = means3d - cam_center[None, :]
    dirs = dirs / torch.clamp(torch.linalg.norm(dirs, dim=-1, keepdim=True), min=1e-12)
    basis = sh_utils.sh_basis(deg, dirs)  # [C, k]
    k = basis.shape[-1]
    rgb = torch.einsum("nk,nkc->nc", basis, shs[:, :k, :]) + 0.5
    return torch.clamp(rgb, min=0.0)


def _bind(lib: ctypes.CDLL) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    # xyz, center, dc, rest, t_row, is_actor, d_rgb, rgb, d_xyz, d_dc, d_rest, rows, K, F, deg_bkgd, deg_obj, stream
    lib.sh_color_f32.argtypes = [p] * 11 + [ll, i, i, i, i, p]
    lib.sh_color_f32.restype = ctypes.c_int


def _kernel_inputs(means3d, cam_center, feat_dc, feat_rest, t_row, is_actor):
    """The inputs as the kernel takes them (float32 contiguous, on one
    card); raises ValueError on what it does not take."""
    C = means3d.shape[0]
    dev = means3d.device
    K = feat_rest.shape[1] + 1 if feat_rest.dim() == 3 else 0
    shapes = (("means3d", means3d, (C, 3)), ("cam_center", cam_center, (3,)),
              ("feat_dc", feat_dc, (C, feat_dc.shape[1] if feat_dc.dim() == 3 else 0, 3)),
              ("feat_rest", feat_rest, (C, K - 1, 3)), ("t_row", t_row, (C,)))
    for name, t, shape in shapes:
        if t is None:
            continue
        if t.dtype != torch.float32 or t.device != dev or tuple(t.shape) != shape:
            raise ValueError(f"sh_color: {name} must be float32 {shape} on {dev}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if K not in (1, 4, 9, 16) or feat_dc.shape[1] < 1:
        raise ValueError(f"sh_color: the kernel takes 1, 4, 9 or 16 coefficients and F >= 1, got K = {K}, "
                         f"F = {feat_dc.shape[1]}")
    if is_actor is not None and (is_actor.dtype != torch.bool or is_actor.shape != (C,) or is_actor.device != dev):
        raise ValueError(f"sh_color: is_actor must be bool [{C}] on {dev}, got {is_actor.dtype} "
                         f"{tuple(is_actor.shape)} on {is_actor.device}")
    return tuple(None if t is None else t.contiguous()
                 for t in (means3d, cam_center, feat_dc, feat_rest, t_row, is_actor))


def _launch(inputs, degs, d_rgb=None):
    """One launch of the forward (d_rgb None: returns rgb) or the backward
    (returns d_means3d, d_feat_dc, d_feat_rest)."""
    means3d, cam_center, feat_dc, feat_rest = inputs[:4]
    C, K = means3d.shape[0], feat_rest.shape[1] + 1
    if d_rgb is None:
        outs = (torch.empty_like(means3d),)
    else:
        outs = (torch.empty_like(means3d), torch.empty_like(feat_dc), torch.empty_like(feat_rest))
    ptr = lambda t: 0 if t is None else t.data_ptr()  # noqa: E731
    rgb, d_xyz, d_dc, d_rest = (outs[0], None, None, None) if d_rgb is None else (None, *outs)
    if C:
        lib = _build.load("sh_color", _bind)
        err = lib.sh_color_f32(*(ptr(t) for t in (*inputs, d_rgb, rgb, d_xyz, d_dc, d_rest)), C, K,
                               feat_dc.shape[1], *degs, _build.stream_of(means3d))
        _build.check(err, "sh_color")
    return outs


class _ShColor(torch.autograd.Function):
    @staticmethod
    def forward(ctx, means3d, cam_center, feat_dc, feat_rest, t_row, is_actor, deg_bkgd, deg_obj):
        inputs = _kernel_inputs(means3d, cam_center, feat_dc, feat_rest, t_row, is_actor)
        (rgb,) = _launch(inputs, (deg_bkgd, deg_obj))
        sh_color.launches += 1
        ctx.save_for_backward(*inputs)
        ctx.degs = (deg_bkgd, deg_obj)
        return rgb

    @staticmethod
    def backward(ctx, d_rgb):
        with span("sh_bwd"):
            inputs = ctx.saved_tensors
            d_means, d_dc, d_rest = _launch(inputs, ctx.degs, d_rgb.contiguous())
            sh_color.bwd_launches += 1
            d_center = -d_means.sum(dim=0) if ctx.needs_input_grad[1] else None
        return d_means, d_center, d_dc, d_rest, None, None, None, None


def sh_color(means3d, cam_center, feat_dc, feat_rest, t_row, is_actor, deg_bkgd: int, deg_obj: int) -> torch.Tensor:
    """rgb [C, 3] of each row's SH colour seen from cam_center [3]:
    means3d [C, 3]; feat_dc [C, F, 3], an actor row's Fourier DC at its
    t_row ([C] float) and a background row's coefficient 0; feat_rest
    [C, K-1, 3], the bands up to the row's active degree (deg_obj for an
    actor row, deg_bkgd else; is_actor [C] bool, None: no actor rows).
    Differentiable in means3d, cam_center, feat_dc and feat_rest, with
    the plain version's gradients (a masked band's exactly 0; the clamp
    passes the gradient where the colour is >= 0). CPU tensors take the
    plain version, CUDA tensors the kernel."""
    if means3d.device.type == "cpu":
        return sh_color_plain(means3d, cam_center, feat_dc, feat_rest, t_row, is_actor, deg_bkgd, deg_obj)
    _build.require_cuda(means3d, "sh_color")
    return _ShColor.apply(means3d, cam_center, feat_dc, feat_rest, t_row, is_actor, int(deg_bkgd), int(deg_obj))


sh_color.launches = 0
sh_color.bwd_launches = 0
