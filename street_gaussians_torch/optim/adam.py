"""Row-masked Adam over dictionaries of tensors.

Port of street_gaussians_tpu/optim/adam.py. Per-row semantics are those
of torch Adam under zero_grad(set_to_none=True) with one parameter group
per sub-model: a row whose mask is 0 this step is skipped entirely (its
moments do not decay and its step count does not grow), and each row
keeps its own step count, so an actor that enters the scene late starts
its bias correction at 1. eps is 1e-15, as the reference's. torch.optim.Adam
has neither the row mask nor the per-row counts.

State and parameters are plain `{name: tensor}` dictionaries; a
parameter of a sub-model without rows (the sky, the corrections) has a
scalar count and no mask.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Union

import torch

Tensors = Dict[str, torch.Tensor]


class AdamState(NamedTuple):
    mu: Tensors  # first moments, keyed as the parameters
    nu: Tensors  # second moments
    count: Tensors  # step counts: [rows] for row-counted leaves, scalar otherwise


def adam_init(params: Tensors, row_counted=()) -> AdamState:
    """Zero moments; per-row [N] counts for the names in row_counted."""
    return AdamState(
        mu={k: torch.zeros_like(p) for k, p in params.items()},
        nu={k: torch.zeros_like(p) for k, p in params.items()},
        count={
            k: p.new_zeros((p.shape[0],) if k in row_counted else ())
            for k, p in params.items()
        },
    )


def _rows(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A per-row [N] tensor shaped to broadcast against like [N, ...]."""
    return x.reshape(x.shape + (1,) * (like.dim() - x.dim()))


def leaf_update(p, g, mu, nu, cnt, lr, mask, b1=0.9, b2=0.999, eps=1e-15):
    """One leaf's step. lr: a float or a per-row [N] tensor; mask: None
    (always active) or a per-row [N] bool/float tensor. Returns (p, mu,
    nu, cnt), new tensors."""
    m = torch.ones((), dtype=p.dtype, device=p.device) if mask is None else mask.to(p.dtype)
    mb = _rows(m, p) if m.dim() else m
    cnt = cnt + m
    mu = mb * (b1 * mu + (1.0 - b1) * g) + (1.0 - mb) * mu
    nu = mb * (b2 * nu + (1.0 - b2) * g * g) + (1.0 - mb) * nu
    c = _rows(cnt, p) if cnt.dim() else cnt
    stepped = c > 0.0
    one = torch.ones((), dtype=p.dtype, device=p.device)
    bc1 = 1.0 - b1 ** torch.where(stepped, c, one)
    bc2 = 1.0 - b2 ** torch.where(stepped, c, one)
    if isinstance(lr, torch.Tensor) and lr.dim():
        lr = _rows(lr, p)
    upd = torch.where(stepped, lr * (mu / bc1) / (torch.sqrt(nu / bc2) + eps), 0.0)
    return p - mb * upd, mu, nu, cnt


def adam_update(
    params: Tensors,
    grads: Tensors,
    state: AdamState,
    lr: Dict[str, Union[float, torch.Tensor]],
    mask: Optional[Dict[str, Optional[torch.Tensor]]] = None,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-15,
):
    """One Adam step over every name of params. Returns (params, state),
    new tensors (the inputs are not modified)."""
    new_p, mu, nu, cnt = {}, {}, {}, {}
    for k, p in params.items():
        m = None if mask is None else mask.get(k)
        new_p[k], mu[k], nu[k], cnt[k] = leaf_update(
            p, grads[k], state.mu[k], state.nu[k], state.count[k], lr[k], m, b1, b2, eps
        )
    return new_p, AdamState(mu=mu, nu=nu, count=cnt)
