"""The comparison that decides `correct`: the numbers, their limits.

Train cells: the program's first steps, driven through the window's own
call and feed from the snapshot, against the reference's steps on the
same views and draws:
  loss_gap    the largest |loss_p - loss_r| / |loss_r| over the steps;
  grad_gap    the worst leaf of | |g_p| - |g_r| | / max(|g_r|, the median
              leaf's |g_r|), g the first step's gradient as Adam got it
              (worked out from its first moments after one step);
  change_gap  the same of the parameters' change over the steps, over
              the leaves whose reference gradient is at least a
              thousandth of the median leaf's (the others move by
              round-off alone).
Train cells whose cycle ends in a densify round, that round (the
cadence at the cycle's last iteration) on the checked steps' state, with
the same draws on both sides:
  stats_gap   the worst of the densification statistics the round reads
              (the summed mean-gradient norms, the AbsGS sums, the
              visible steps, the largest radii) as |p - r| / |r|;
  densify_gap the worst of: the rows cloned, the rows removed (pruned
              or split) and the alive mask after the round, each as the
              rows that differ over the reference's rows of that kind
              (the alive mask's over the rows removed and written); the
              split count's gap; the gap of the norms of the new rows'
              log scales.
  checked_failed  the checked steps that dropped an instance or gave a
              non-finite loss (limit 0).
Serve cells: sampled views rendered in the window against the
reference's render of the same views:
  rgb_diff    the share of the image's uint8 values that differ from
              the reference's, worst view;
  rgb_off     the share more than one level from the reference's;
  rgb_far     the share more than 16 levels from the reference's;
  acc_gap     the largest |acc_p - acc_r|, worst view;
  depth_gap   the largest |depth_p - depth_r| over the reference's
              largest depth, worst view.
Each limit sits between the program's readings over a dozen seeds and
more and the lowest reading of the control (the reference with its
matrix products in TF32, the precision below the float32 with TF32 off
that the program states) or of a planted fault; PERF.md gives the
readings.
"""

from __future__ import annotations

import statistics
from typing import Dict, List

import torch

LIMITS = {
    "train": {"loss_gap": 8e-4, "grad_gap": 0.05, "change_gap": 0.012},
    "densify": {"stats_gap": 0.03, "densify_gap": 0.015},
    "serve": {"rgb_diff": 0.05, "rgb_off": 0.01, "rgb_far": 2e-5, "acc_gap": 0.12, "depth_gap": 0.08},
}


def leaf_norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(v.double().norm()) for k, v in tensors.items()}


def leaf_gaps(got: Dict[str, float], want: Dict[str, float], keys: List[str]) -> Dict[str, float]:
    """Each leaf's | |got| - |want| | / max(|want|, median |want|)."""
    med = statistics.median([want[k] for k in keys])
    return {k: abs(got[k] - want[k]) / max(want[k], med, 1e-30) for k in keys}


def norm_gap(got: Dict[str, float], want: Dict[str, float], keys: List[str]) -> float:
    """The worst leaf's gap (leaf_gaps)."""
    return max(leaf_gaps(got, want, keys).values())


def train_numbers(prog_losses, ref_losses, prog_g, ref_g, prog_dp, ref_dp) -> Dict[str, float]:
    loss = max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(prog_losses, ref_losses))
    keys = sorted(ref_g)
    med_g = statistics.median([ref_g[k] for k in keys])
    moving = [k for k in keys if ref_g[k] >= 1e-3 * med_g]
    return {"loss_gap": loss, "grad_gap": norm_gap(prog_g, ref_g, keys),
            "change_gap": norm_gap(prog_dp, ref_dp, moving)}


def stats_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """Each statistic's |p - r| / |r|."""
    return {k: float((prog[k].double() - ref[k].double()).norm() / ref[k].double().norm().clamp(min=1e-30))
            for k in ref}


def densify_parts(prog: dict, ref: dict) -> Dict[str, float]:
    """The parts of densify_gap. prog: the program's state around the
    round ("alive0", "xyz0" before; "alive", "xyz", "log_scale" after;
    "n_split"); ref: reference/densify's round. The program's rows
    removed are those alive before that are dead or hold another
    Gaussian after; its clones, the rows alive before whose exact
    position a written row carries."""
    alive0, xyz0, alive = prog["alive0"], prog["xyz0"], prog["alive"]
    moved = (prog["xyz"] != xyz0).any(dim=1)
    removed = alive0 & (~alive | moved)
    new = alive & (~alive0 | moved)
    rows0 = alive0.nonzero()[:, 0]
    keys = torch.cat([xyz0[rows0], prog["xyz"][new]]).contiguous().view(torch.int32)
    _, inv = torch.unique(keys, dim=0, return_inverse=True)
    clone = torch.zeros_like(alive0)
    clone[rows0[torch.isin(inv[: rows0.shape[0]], inv[rows0.shape[0]:])]] = True

    def share(a, b, over):
        return int((a ^ b).sum()) / max(int(over), 1)

    ls_p = float(prog["log_scale"][new].double().norm())
    ls_r = float(ref["log_scale"][ref["new"]].double().norm())
    return {"clone": share(clone, ref["clone"], ref["clone"].sum()),
            "removed": share(removed, ref["removed"], ref["removed"].sum()),
            "alive": share(alive, ref["alive"], ref["removed"].sum() + ref["new"].sum()),
            "split": abs(prog["n_split"] - ref["n_split"]) / max(ref["n_split"], 1),
            "new_log_scale": abs(ls_p - ls_r) / max(ls_r, 1e-30)}


def densify_numbers(prog: dict, ref_stats: Dict[str, torch.Tensor], ref_round: dict) -> Dict[str, float]:
    return {"stats_gap": max(stats_gaps(prog["stats"], ref_stats).values()),
            "densify_gap": max(densify_parts(prog, ref_round).values())}


def to_uint8(rgb: torch.Tensor) -> torch.Tensor:
    """The viewer's and trajectory's uint8: (clip(rgb, 0, 1) * 255) cast."""
    return (rgb.clamp(0, 1) * 255).to(torch.uint8)


def view_numbers(rgb8_p: torch.Tensor, acc_p, depth_p, ref: dict) -> Dict[str, float]:
    r8 = to_uint8(ref["rgb"]).cpu().to(torch.int16)
    d8 = (rgb8_p.cpu().to(torch.int16) - r8).abs()
    dmax = float(ref["depth"].abs().max().clamp(min=1e-6))
    return {"rgb_diff": float((d8 > 0).float().mean()), "rgb_off": float((d8 > 1).float().mean()),
            "rgb_far": float((d8 > 16).float().mean()),
            "acc_gap": float((acc_p - ref["acc"]).abs().max()),
            "depth_gap": float((depth_p - ref["depth"]).abs().max()) / dmax}


def judge(numbers: Dict[str, float], limits: Dict[str, float]):
    """(correct, [[name, value, limit]]) with every number at or under
    its limit for correct."""
    rows = [[k, numbers[k], limits[k]] for k in limits]
    ok = all(v == v and v <= lim for _, v, lim in rows)
    return ok, rows
