"""ops/sh_color.py's plain version against the composition that compose_frame
and preprocess_gaussians wrote out before it (the Fourier DC, the band
mask, the [C, K, 3] table cat, utils/sh.sh_basis, the einsum, + 0.5, the
clamp), in value and gradient, on the CPU. The kernel is held against
the plain version on the card (tests/test_torch_cuda.py).

Tolerance: the two run the same float32 operations, except that the
plain version evaluates the basis only up to the highest active degree
where the composition evaluated every band and multiplied the masked
ones by 0; the einsum's sums then differ only in how many exact zeros
they add, so rtol 1e-6."""

import math

import pytest
import torch

from street_gaussians_torch.ops import sh_color as shc
from street_gaussians_torch.utils import sh as sh_utils

TOL = dict(rtol=1e-6, atol=1e-7)


def composed_colour(means3d, cam_center, feat_dc, feat_rest, t_row, is_actor, deg_bkgd, deg_obj):
    """The colour as compose_frame and preprocess_gaussians computed it."""
    F = feat_dc.shape[1]
    max_deg = math.isqrt(feat_rest.shape[1] + 1) - 1
    basis = sh_utils.idft_basis(t_row, F)
    bkgd_basis = torch.zeros_like(basis)
    bkgd_basis[:, 0] = 1.0
    basis = torch.where(is_actor[:, None], basis, bkgd_basis)
    dc = torch.einsum("cf,cfk->ck", basis, feat_dc)
    deg_row = torch.where(is_actor, deg_obj, deg_bkgd)
    K = (max_deg + 1) ** 2
    band = torch.floor(torch.sqrt(torch.arange(1, K, dtype=torch.float32))).to(torch.int64)
    rest_mask = (band[None, :] <= deg_row[:, None]).to(torch.float32)
    shs = torch.cat([dc[:, None, :], feat_rest * rest_mask[..., None]], dim=1)
    dirs = means3d - cam_center[None, :]
    dirs = dirs / torch.clamp(torch.linalg.norm(dirs, dim=-1, keepdim=True), min=1e-12)
    b = sh_utils.sh_basis(max_deg, dirs)
    return torch.clamp(torch.einsum("nk,nkc->nc", b, shs[:, : b.shape[-1], :]) + 0.5, min=0.0)


@pytest.mark.parametrize("K", [1, 4, 16])
@pytest.mark.parametrize("F", [1, 5])
def test_plain_sh_color_is_the_composition(K, F):
    """Rows of actors and background, degrees at and below the maximum
    (masked bands), a row on the camera centre; rgb and the gradients of
    means3d, cam_center, feat_dc and feat_rest."""
    gen = torch.Generator().manual_seed(K * 10 + F)
    C = 300
    max_deg = math.isqrt(K) - 1
    means3d = torch.randn(C, 3, generator=gen) * 3.0
    cam_center = torch.tensor([0.3, -0.2, 0.5])
    means3d[7] = cam_center
    feat_dc = torch.randn(C, F, 3, generator=gen) * 0.5
    feat_rest = torch.randn(C, K - 1, 3, generator=gen) * 0.3
    t_row = torch.rand(C, generator=gen) * 2.0 - 0.5
    is_actor = torch.rand(C, generator=gen) < 0.4
    cot = torch.randn(C, 3, generator=gen)
    for degs in ((max_deg, max_deg), (max(max_deg - 1, 0), max_deg), (max_deg, 0)):
        leaves = [t.clone().requires_grad_(True) for t in (means3d, cam_center, feat_dc, feat_rest)]
        got = shc.sh_color(*leaves[:2], *leaves[2:], t_row, is_actor, *degs)
        want_leaves = [t.clone().requires_grad_(True) for t in (means3d, cam_center, feat_dc, feat_rest)]
        want = composed_colour(*want_leaves, t_row, is_actor, *degs)
        torch.testing.assert_close(got, want, **TOL)
        g_got = torch.autograd.grad((got * cot).sum(), leaves, allow_unused=True)
        g_want = torch.autograd.grad((want * cot).sum(), want_leaves, allow_unused=True)
        for name, a, b, x in zip(("means3d", "cam_center", "feat_dc", "feat_rest"), g_got, g_want, leaves):
            # at K = 1 (degree 0) the colour does not depend on the direction
            a, b = (torch.zeros_like(x) if g is None else g for g in (a, b))
            torch.testing.assert_close(a, b, **TOL, msg=lambda m: f"{degs} {name}: {m}")


def test_one_cloud_table_is_its_dc_and_rest():
    """A single cloud's [N, K, 3] table (models/simple_renderer.py's
    shs): feat_dc its first coefficient, feat_rest the others, no actor
    rows; sh_table gives the table back with the bands above the degree
    masked."""
    shs = torch.randn(50, 16, 3, generator=torch.Generator().manual_seed(0))
    sh = shc.inputs_from_table(shs, 2)
    assert sh.t_row is None and sh.is_actor is None and (sh.deg_bkgd, sh.deg_obj) == (2, 2)
    table = shc.sh_table(*sh)
    assert torch.equal(table[:, :9], shs[:, :9]) and not table[:, 9:].any()
