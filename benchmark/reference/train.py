"""Plain PyTorch reference of a training step of the street scene.

The Street Gaussians objective (Yan et al. 2024, the published recipe's
weights): (1 - lambda_dssim) lambda_l1 L1 + lambda_dssim (1 - SSIM) on
the image, the sky's binary cross-entropy on the accumulated opacity
(weighted by the camera's sky scale), the object-opacity entropy inside
the actors' boxes once the actors are rendered alone, and the LiDAR
depth's L1 over the 95% of returns with the smallest error. Gradients
by autograd through reference/render.py; then Adam (b1 0.9, b2 0.999,
eps 1e-15) with the schedules of 3D Gaussian splatting and Street
Gaussians: a Gaussian row steps only while alive and its model is in
the frame (its own step count), the position rate decays exponentially
over position_lr_max_steps and scales with the model's extent, the
tracklet residuals and the sky on their own exponential schedules.
Nothing here imports or reads the program.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from benchmark.reference.densify import step_statistics
from benchmark.reference.render import mm, render

B1, B2, EPS = 0.9, 0.999, 1e-15


def initial_state(scene) -> dict:
    """The snapshot's parameters and Adam state, from the scene."""
    p = {"gaussians.xyz": scene.xyz, "gaussians.feat_dc": scene.feat_dc, "gaussians.feat_rest": scene.feat_rest,
         "gaussians.log_scale": scene.log_scale, "gaussians.rot": scene.rot,
         "gaussians.opacity_logit": scene.opacity_logit, "gaussians.semantic": scene.semantic,
         "actor_pose.opt_trans": scene.opt_trans, "actor_pose.opt_rots": scene.opt_rots}
    if scene.cfg["include_sky"]:
        p["sky.cubemap"] = scene.sky_cubemap
    p = {k: v.detach().clone() for k, v in p.items()}
    alive = scene.alive.float()
    count = {k: (alive * scene.adam_count if k.startswith("gaussians.")
                 else torch.tensor(float(scene.adam_count), device=v.device)) for k, v in p.items()}
    return {"params": p, "mu": {k: torch.zeros_like(v) for k, v in p.items()},
            "nu": {k: scene.adam_nu[k].clone() for k in p}, "count": count, "step": scene.adam_count}


def ssim(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Mean SSIM of [H, W, 3] images: 11x11 Gaussian window (sigma 1.5),
    zero padding, C1 = 0.01^2, C2 = 0.03^2. The separable blur is two
    products with banded [W, W] and [H, H] matrices."""
    H, W = x.shape[0], x.shape[1]
    g = torch.exp(-(torch.arange(11, dtype=torch.float32, device=x.device) - 5) ** 2 / (2 * 1.5 ** 2))
    g = g / g.sum()

    def band(n):
        i = torch.arange(n, device=x.device)
        d = i[None, :] - i[:, None]
        return torch.where(d.abs() <= 5, g[(d + 5).clamp(0, 10)], torch.zeros((), device=x.device))

    Bw, Bh = band(W), band(H)

    def blur(a):  # [H, W, 3] -> [H, W, 3]
        a = mm(a.permute(2, 0, 1), Bw)  # along x
        return mm(a.transpose(1, 2), Bh).permute(2, 1, 0)  # along y

    mx, my = blur(x), blur(y)
    sxx = blur(x * x) - mx * mx
    syy = blur(y * y) - my * my
    sxy = blur(x * y) - mx * my
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    return (((2 * mx * my + c1) * (2 * sxy + c2)) / ((mx * mx + my * my + c1) * (sxx + syy + c2))).mean()


def trimmed_depth_l1(expected: torch.Tensor, lidar: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean |expected - lidar| over the returns whose error is at most
    the floor(0.95 n)-th smallest."""
    err = (expected - lidar).abs()
    e = err[mask]
    n = e.numel()
    if n == 0:
        return err.sum() * 0.0
    k = max(int(math.floor(0.95 * n)), 1)
    thr = torch.sort(e.detach()).values[k - 1]
    keep = mask & (err <= thr)
    return err[keep].sum() / max(int(keep.sum()), 1)


def losses(scene, out: dict, truth, recipe: dict, cam: int, out_obj=None, half: bool = False):
    """The recipe's loss. half: a planted fault, every term over the top
    half of the image's rows only (the mean over them)."""
    o = recipe["optim"]
    if half:
        h = scene.H // 2
        out = {k: v[:h] for k, v in out.items() if k in ("rgb", "acc", "depth")}
        out_obj = None if out_obj is None else {"acc": out_obj["acc"][:h]}
        truth = type(truth)(image=truth.image[:h], sky_mask=truth.sky_mask[:h], lidar_depth=truth.lidar_depth[:h],
                            obj_bound=truth.obj_bound[:h])
    img, gt = out["rgb"], truth.image
    l1 = (img - gt).abs().mean()
    loss = (1 - o["lambda_dssim"]) * o["lambda_l1"] * l1 + o["lambda_dssim"] * (1 - ssim(img, gt))
    if o.get("lambda_sky", 0.0) > 0:
        acc = out["acc"].clamp(1e-6, 1 - 1e-6)[..., None]
        bce = torch.where(truth.sky_mask, -torch.log(1 - acc), -torch.log(acc)).mean()
        scales = o.get("lambda_sky_scale", [])
        loss = loss + o["lambda_sky"] * bce * (float(scales[cam]) if cam < len(scales) else 1.0)
    if out_obj is not None:
        a = out_obj["acc"].clamp(1e-6, 1 - 1e-6)[..., None]
        ent = torch.where(truth.obj_bound, -(a * torch.log(a) + (1 - a) * torch.log(1 - a)), -torch.log(1 - a)).mean()
        loss = loss + o["lambda_reg"] * ent
    if o.get("lambda_depth_lidar", 0.0) > 0:
        expected = out["depth"] / out["acc"].clamp(min=1e-2)
        loss = loss + o["lambda_depth_lidar"] * trimmed_depth_l1(expected, truth.lidar_depth, truth.lidar_depth > 0)
    return loss


def expon(step: int, init: float, final: float, max_steps: int, warmup: int = 0) -> float:
    if step < warmup:
        return 0.0
    t = min(max(step / max_steps, 0.0), 1.0)
    return math.exp(math.log(init) * (1 - t) + math.log(final) * t)


def learning_rates(scene, recipe: dict, step: int) -> Dict[str, object]:
    o = recipe["optim"]
    mid = scene.model_id
    ext = torch.tensor(scene.models.extent, dtype=torch.float32, device=mid.device)[mid]
    t = min(max(step / o["position_lr_max_steps"], 0.0), 1.0)
    xyz = torch.exp(torch.log(o["position_lr_init"] * ext) * (1 - t) + torch.log(o["position_lr_final"] * ext) * t)
    lr = {"gaussians.xyz": xyz, "gaussians.feat_dc": o["feature_lr"], "gaussians.feat_rest": o["feature_lr"] / 20,
          "gaussians.log_scale": o["scaling_lr"], "gaussians.rot": o["rotation_lr"],
          "gaussians.opacity_logit": o["opacity_lr"], "gaussians.semantic": o["semantic_lr"],
          "actor_pose.opt_trans": expon(step, o["track_position_lr_init"], o["track_position_lr_final"],
                                        o["track_position_max_steps"], o["opacity_reset_interval"]),
          "actor_pose.opt_rots": expon(step, o["track_rotation_lr_init"], o["track_rotation_lr_final"],
                                       o["track_rotation_max_steps"], o["opacity_reset_interval"]),
          "sky.cubemap": expon(step, 0.01, 0.0001, recipe["train"]["iterations"])}
    return lr


def step(scene, state: dict, recipe: dict, view, truth, flip, jitter, object_loss: bool, half: bool = False,
         statistics: bool = False):
    """One training step; returns (new state, loss, {leaf: gradient},
    the densification statistics of the full render (reference/densify's
    step_statistics) or None). half: see losses."""
    p = {k: v.detach().requires_grad_(True) for k, v in state["params"].items()}
    wb = recipe["data"].get("white_background", False)
    C = scene.model_id.shape[0]
    m2d_off = torch.zeros((C, 2), device=scene.model_id.device, requires_grad=True) if statistics else None
    abs_sink = torch.zeros((C, 2), dtype=torch.float64, device=scene.model_id.device) if statistics else None
    out = render(scene, p, view, train=True, flip=flip, jitter=jitter, white_background=wb, m2d_off=m2d_off,
                 abs_sink=abs_sink)
    out_obj = None
    if object_loss:
        actors = range(1, len(scene.models.names))
        out_obj = render(scene, p, view, train=True, flip=flip, models=actors, with_sky=False, white_background=wb)
    loss = losses(scene, out, truth, recipe, view.cam, out_obj, half)
    names = list(p)
    wrt = [p[k] for k in names] + ([m2d_off] if statistics else [])
    grads = torch.autograd.grad(loss, wrt, allow_unused=True)
    stats = None
    if statistics:
        g_m2d = torch.zeros_like(m2d_off) if grads[-1] is None else grads[-1]
        stats = step_statistics(g_m2d, abs_sink, out["radius"], scene.W, scene.H)
    grads = {k: (torch.zeros_like(p[k]) if g is None else g) for k, g in zip(names, grads)}
    # Adam on the rows in play: alive, their model in the frame
    m = scene.models
    in_range = torch.tensor([(m.start_frame[i] <= view.frame <= m.end_frame[i]) for i in range(len(m.names))],
                            device=scene.model_id.device)
    rows = scene.alive & in_range[scene.model_id]
    lr = learning_rates(scene, recipe, state["step"])
    new = {"params": {}, "mu": {}, "nu": {}, "count": {}, "step": state["step"] + 1}
    with torch.no_grad():
        for k in names:
            x, g = state["params"][k], grads[k]
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
    return new, loss.detach(), grads, stats
