"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Without a CUDA card every test here skips. This file imports no
JAX, so it also runs where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import pytest
import torch

from chip_smoke import random_blend_case, random_expand_case
from street_gaussians_torch.ops import fill, tile_raster2

# kernel B: the two differ only in the order of f32 sums (see
# tests/test_torch_blend.py)
BLEND_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("pad", [-4104, 0, 333])
def test_expand_runs_kernel_matches_plain(cuda_device, pad):
    """Exact: the kernel copies values. S below, at and above total."""
    v, o, t, S = random_expand_case(2, 5000, cuda_device)
    before = fill.expand_runs.launches
    got = fill.expand_runs(v, o, t, S + pad)
    torch.cuda.synchronize()
    assert fill.expand_runs.launches == before + 1
    assert torch.equal(got, fill.expand_runs_plain(v, o, t, S + pad))


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 1])
def test_blend_kernel_matches_plain(cuda_device, seed):
    case = random_blend_case(seed, cuda_device, grid_x=5, grid_y=4, max_count=400)
    got = tile_raster2.tile_blend_instances(*case)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, tile_raster2.tile_blend_plain(*case), **BLEND_TOL)


@pytest.mark.cuda
def test_wrappers_reject_bad_inputs(cuda_device):
    with pytest.raises(ValueError):
        fill.expand_runs(
            torch.zeros((2, 4), device=cuda_device), torch.zeros(4, dtype=torch.int32),
            torch.tensor(0, dtype=torch.int32, device=cuda_device), 8,
        )
    p = torch.zeros((2, 16, 128), device=cuda_device)
    z = torch.zeros(1, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError):
        tile_raster2.tile_blend_instances(p, z, z, 9, 1, 1)
