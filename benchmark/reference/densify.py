"""Plain PyTorch reference of the densification statistics and of one
densify-and-prune round.

Written from the methods, not from the program: 3D Gaussian splatting's
adaptive density control (Kerbl et al. 2023: the view-space mean
gradient's norm, in NDC units, averaged over the steps a Gaussian was
visible; clone the small ones at or over the threshold, split the large
ones into two samples drawn from the Gaussian with the scale / 1.6 and
drop the original; prune those under the minimum opacity and, past the
first opacity reset, the too large), AbsGS (Ye et al. 2024: the
background's signal is the sum over pixels of the absolute per-pixel
gradient, with its own threshold) and Street Gaussians' actor rule (an
actor's Gaussian also goes when one of two samples of it falls outside
its box). Conventions that decide which rows change are the system's
documented ones: a Gaussian counts as visible where its radius (ceil of
3 sqrt of the larger eigenvalue) is positive; the gradients are scaled by
(W / 2, H / 2); the large-Gaussian prune of the background is limited to
twice the scene sphere's radius; the packed buffers keep their size, so
a new row takes a dead slot of its own model's slice (the k-th new row,
clones and first samples in row order before second samples, the k-th
free slot in row order; past the last free slot it is dropped). The
random draws are the benchmark's, handed to both sides. Nothing here
imports or reads the program.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from benchmark.reference.render import quat_rotmat


def step_statistics(g_m2d: torch.Tensor, g_abs: torch.Tensor, radius: torch.Tensor, W: int, H: int):
    """One step's statistics: (signal [C, 2] = the scaled mean gradient's
    norm and the scaled absolute gradients' sum, visible [C], radius
    [C]), each 0 where the Gaussian is not visible."""
    scale = torch.tensor([W / 2.0, H / 2.0], dtype=torch.float64, device=g_m2d.device)
    vis = radius > 0
    sig = torch.stack([(g_m2d.double() * scale).norm(dim=-1), (g_abs.double() * scale).sum(-1)], -1)
    return (torch.where(vis[:, None], sig, torch.zeros_like(sig)), vis.double(),
            torch.where(vis, radius.double(), torch.zeros_like(radius, dtype=torch.float64)))


def accumulate(acc: Optional[Dict[str, torch.Tensor]], stats) -> Dict[str, torch.Tensor]:
    """The round's running statistics: sums of the signals and of the
    visible steps, the largest radius."""
    sig, vis, rad = stats
    if acc is None:
        return {"grad": sig[:, 0], "absgrad": sig[:, 1], "denom": vis, "max_radii": rad}
    return {"grad": acc["grad"] + sig[:, 0], "absgrad": acc["absgrad"] + sig[:, 1], "denom": acc["denom"] + vis,
            "max_radii": torch.maximum(acc["max_radii"], rad)}


def zero_statistics(capacity: int, device) -> Dict[str, torch.Tensor]:
    z = torch.zeros(capacity, dtype=torch.float64, device=device)
    return {"grad": z, "absgrad": z, "denom": z, "max_radii": z}


def densify(scene, optim: dict, p: Dict[str, torch.Tensor], alive: torch.Tensor, acc: Dict[str, torch.Tensor],
            noise, prune_big: bool, threshold_scale: float = 1.0) -> Dict[str, torch.Tensor]:
    """One round over the rows: {"clone", "split", "removed" (pruned or
    split), "alive" (after), "new" (the slots written), "xyz",
    "log_scale" (after)} and the counts "n_clone", "n_split". noise: the
    box test's [C, 2, 3] and the two split samples' [C, 3] standard
    normals. threshold_scale: a planted fault, every threshold scaled."""
    m = scene.models
    mid = scene.model_id
    dev = mid.device
    is_actor = torch.as_tensor(m.track_id >= 0, device=dev)[mid]
    thr_bkgd = optim.get("densify_grad_threshold_bkgd", optim["densify_grad_threshold"])
    thr_obj = optim.get("densify_grad_threshold_obj", optim["densify_grad_threshold"])
    thr = torch.where(is_actor, torch.tensor(thr_obj, dtype=torch.float64, device=dev),
                      torch.tensor(thr_bkgd, dtype=torch.float64, device=dev)) * threshold_scale
    use_abs = torch.where(is_actor, torch.tensor(bool(optim.get("densify_grad_abs_obj", False)), device=dev),
                          torch.tensor(bool(optim.get("densify_grad_abs_bkgd", False)), device=dev))
    signal = torch.where(use_abs, acc["absgrad"], acc["grad"])
    avg = torch.where(acc["denom"] > 0, signal / acc["denom"].clamp(min=1.0), torch.zeros_like(signal))

    xyz, log_scale = p["gaussians.xyz"].detach(), p["gaussians.log_scale"].detach()
    scale = torch.exp(log_scale)
    biggest = scale.max(dim=1).values
    extent = torch.as_tensor(m.extent, dtype=torch.float32, device=dev)[mid]
    picked = alive & (avg >= thr)
    small = biggest <= optim["percent_dense"] * extent
    clone, split = picked & small, picked & ~small

    opacity = torch.sigmoid(p["gaussians.opacity_logit"].detach())[:, 0]
    prune = alive & (opacity < optim["min_opacity"])
    if prune_big:
        big = biggest > extent * optim["percent_big_ws"]
        centre = torch.as_tensor(scene.sphere_center, dtype=torch.float32, device=dev)
        near = (xyz - centre).norm(dim=-1) <= 2.0 * scene.sphere_radius
        R = quat_rotmat(p["gaussians.rot"].detach())
        pts = torch.einsum("cij,csj->csi", R, noise[0] * scale[:, None, :]) + xyz[:, None, :]
        half = torch.as_tensor(m.box_half, dtype=torch.float32, device=dev)[mid][:, None, :]
        inside = ((pts >= -half) & (pts <= half)).all(dim=2).all(dim=1)
        prune = prune | (alive & torch.where(is_actor, big | ~inside, big & near))
    removed = prune | split
    alive_after = alive & ~removed

    R = quat_rotmat(p["gaussians.rot"].detach())
    sample1 = xyz + torch.einsum("cij,cj->ci", R, noise[1] * scale)
    sample2 = xyz + torch.einsum("cij,cj->ci", R, noise[2] * scale)
    split_ls = torch.log(scale / 1.6)
    out_xyz, out_ls = xyz.clone(), log_scale.clone()
    new_alive = alive_after.clone()
    new = torch.zeros_like(alive)
    for s0, s1 in m.slices.tolist():
        rows = torch.arange(s0, s1, device=dev)
        free = rows[~alive_after[s0:s1]]
        first = rows[(clone | split)[s0:s1]]
        second = rows[split[s0:s1]]
        src = torch.cat([first, second])
        n = min(int(src.shape[0]), int(free.shape[0]))
        src, dst = src[:n], free[:n]
        is_second = torch.arange(n, device=dev) >= first.shape[0]
        is_split = split[src]
        pos = torch.where(is_second[:, None], sample2[src], torch.where(is_split[:, None], sample1[src], xyz[src]))
        out_xyz[dst] = pos
        out_ls[dst] = torch.where(is_split[:, None], split_ls[src], log_scale[src])
        new_alive[dst] = True
        new[dst] = True
    return {"clone": clone, "split": split, "removed": removed, "alive": new_alive, "new": new, "xyz": out_xyz,
            "log_scale": out_ls, "n_clone": int(clone.sum()), "n_split": int(split.sum())}
