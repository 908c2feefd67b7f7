"""The Adam kernel's wrapper on the CPU: each leaf's table entry (row
width, flags, lr) and the leaves it refuses, and the CPU path, which
runs the plain version and launches nothing. The kernel itself is held
bit for bit against the plain version on the card
(tests/test_torch_cuda.py::test_adam_kernel_is_bit_equal_to_plain)."""

import pytest
import torch

from street_gaussians_torch.optim import adam

R = 7


def _leaf(shape, cnt_shape=(R,)):
    return [torch.zeros(shape) for _ in range(4)] + [torch.zeros(cnt_shape)]


@pytest.mark.parametrize("shape,cnt_shape,lr,mask,want", [
    ((R, 15, 3), (R,), torch.ones(R), torch.ones(R, dtype=torch.bool), (R * 45, 45, adam.ROW_COUNT, 0.0)),
    ((R, 1), (R,), 2e-3, torch.ones(R, dtype=torch.bool), (R, 1, adam.ROW_COUNT, 2e-3)),
    ((6, 4, 4, 3), (), 0.5, None, (288, 48, 0, 0.5)),
    ((), (), 1, None, (1, 1, 0, 1.0)),
])
def test_kernel_leaf_entry(shape, cnt_shape, lr, mask, want):
    assert adam.kernel_leaf("x", *_leaf(shape, cnt_shape), lr, mask) == want


@pytest.mark.parametrize("change", ["float64", "non_contiguous", "grad_shape", "count_shape", "mask_with_scalar_count",
                                    "mask_dtype", "mask_float", "lr_shape", "lr_0dim", "lr_dtype", "lr_type"])
def test_kernel_leaf_refuses(change):
    p, g, mu, nu, cnt = _leaf((R, 3))
    lr, mask = 1e-3, torch.ones(R, dtype=torch.bool)
    if change == "float64":
        mu = mu.double()
    elif change == "non_contiguous":
        g = torch.zeros(3, R).t()
    elif change == "grad_shape":
        g = torch.zeros(R, 4)
    elif change == "count_shape":
        cnt = torch.zeros(R + 1)
    elif change == "mask_with_scalar_count":
        cnt = torch.zeros(())
    elif change == "mask_dtype":
        mask = torch.ones(R, dtype=torch.int64)
    elif change == "mask_float":
        mask = torch.ones(R)
    elif change == "lr_0dim":
        lr = torch.tensor(1e-3)
    elif change == "lr_shape":
        lr = torch.ones(R, 1)
    elif change == "lr_dtype":
        lr = torch.ones(R, dtype=torch.float64)
    elif change == "lr_type":
        lr = "1e-3"
    with pytest.raises(ValueError):
        adam.kernel_leaf("x", p, g, mu, nu, cnt, lr, mask)


def test_cpu_tensors_take_the_plain_version():
    gen = torch.Generator().manual_seed(0)
    params = {"a": torch.randn(R, 3, generator=gen), "b": torch.randn(2, 5, generator=gen)}
    grads = {k: torch.randn(p.shape, generator=gen) for k, p in params.items()}
    state = adam.adam_init(params, row_counted={"a"})
    lr, mask = {"a": torch.full((R,), 1e-2), "b": 1e-3}, {"a": torch.arange(R) % 2 == 0}
    launches = adam.adam_update.launches
    got_p, got = adam.adam_update(params, grads, state, lr, mask)
    want_p, want = adam.adam_update_plain(params, grads, state, lr, mask)
    assert adam.adam_update.launches == launches
    for k in params:
        for a, b in ((got_p[k], want_p[k]), (got.mu[k], want.mu[k]), (got.nu[k], want.nu[k]),
                     (got.count[k], want.count[k])):
            assert torch.equal(a, b)
