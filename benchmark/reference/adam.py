"""Plain PyTorch reference of the recipes' masked Adam step (b1 0.9, b2
0.999, eps 1e-15, reference/train.py's constants): a Gaussian leaf
("gaussians.*") steps on the rows in play only, each row with its own
step count, the other rows keeping their values and moments; any other
leaf steps every time with one count. Nothing here imports or reads the
program."""

from __future__ import annotations

from typing import Dict

import torch

from benchmark.reference.train import B1, B2, EPS


def step(state: dict, grads: Dict[str, torch.Tensor], rows: torch.Tensor, lr: Dict[str, object]) -> dict:
    """One step of every leaf of state["params"]; lr: a float or a
    per-row tensor a leaf. Returns the new state (step + 1)."""
    new = {"params": {}, "mu": {}, "nu": {}, "count": {}, "step": state["step"] + 1}
    with torch.no_grad():
        for k, x in state["params"].items():
            g = grads[k]
            if k.startswith("gaussians."):
                msk = rows.float().reshape((-1,) + (1,) * (x.dim() - 1))
                cnt = state["count"][k] + rows.float()
                c = cnt.reshape(msk.shape)
            else:
                msk = torch.ones((), device=x.device)
                cnt = state["count"][k] + 1
                c = cnt
            mu = msk * (B1 * state["mu"][k] + (1 - B1) * g) + (1 - msk) * state["mu"][k]
            nu = msk * (B2 * state["nu"][k] + (1 - B2) * g * g) + (1 - msk) * state["nu"][k]
            rate = lr[k]
            if isinstance(rate, torch.Tensor):
                rate = rate.reshape(msk.shape)
            cs = torch.where(c > 0, c, torch.ones_like(c))
            upd = torch.where(c > 0, rate * (mu / (1 - B1 ** cs)) / (torch.sqrt(nu / (1 - B2 ** cs)) + EPS),
                              torch.zeros_like(mu))
            new["params"][k] = x - msk * upd
            new["mu"][k], new["nu"][k], new["count"][k] = mu, nu, cnt
    return new
