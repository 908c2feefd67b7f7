"""Plain PyTorch reference of 3D Gaussian splatting's static-scene render
and training step at any SH degree (Kerbl et al. 2023).

Written from the method, not from the program: one cloud of Gaussians
(no actors, no sky), the view-dependent colour as real spherical
harmonics of degrees 0-3 along the camera -> mean direction with 3DGS's
constants (its utils/sh_utils.py), bands switched on one a thousand
iterations (oneupSHdegree), + 0.5 and clamped at 0; the objective
(1 - lambda_dssim) lambda_l1 L1 + lambda_dssim (1 - SSIM) over the
background colour; Adam (reference/adam.py) on the alive rows with
their own step counts, the position rate decaying
exponentially over position_lr_max_steps times the scene's extent, the
higher SH bands at feature_lr / 20.

The degree-free parts come from reference/render.py (the EWA
projection's geometry, the blocked, checkpointed compositing, the
quaternions, `mm` and its TF32 control) and reference/train.py (SSIM),
unchanged; nothing here imports or reads the program. The compositing
runs in blocks of tiles (render.rasterize), so the reference fits at
the configuration's full size.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from benchmark.reference import adam as ref_adam
from benchmark.reference.render import mm, project, quat_rotmat, rasterize
from benchmark.reference.train import ssim

# real SH constants of 3D Gaussian splatting (utils/sh_utils.py)
SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005, -1.0925484305920792, 0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658, 0.3731763325901154, -0.4570457994644658,
         1.445305721320277, -0.5900435899266435)
LEAVES = ("gaussians.xyz", "gaussians.feat_dc", "gaussians.feat_rest", "gaussians.log_scale", "gaussians.rot",
          "gaussians.opacity_logit", "gaussians.semantic")


def sh_basis(d: torch.Tensor, degree: int) -> torch.Tensor:
    """The (degree + 1)^2 real SH basis functions [N, K] at unit
    directions d [N, 3], band-major, with 3DGS's signs."""
    x, y, z = d.unbind(-1)
    cols = [torch.full_like(x, SH_C0)]
    if degree >= 1:
        cols += [-SH_C1 * y, SH_C1 * z, -SH_C1 * x]
    if degree >= 2:
        xx, yy, zz, xy, yz, xz = x * x, y * y, z * z, x * y, y * z, x * z
        cols += [SH_C2[0] * xy, SH_C2[1] * yz, SH_C2[2] * (2.0 * zz - xx - yy), SH_C2[3] * xz,
                 SH_C2[4] * (xx - yy)]
    if degree >= 3:
        cols += [SH_C3[0] * y * (3.0 * xx - yy), SH_C3[1] * xy * z, SH_C3[2] * y * (4.0 * zz - xx - yy),
                 SH_C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy), SH_C3[4] * x * (4.0 * zz - xx - yy),
                 SH_C3[5] * z * (xx - yy), SH_C3[6] * x * (xx - 3.0 * yy)]
    return torch.stack(cols, -1)


def active_degree(step: int, degree: int) -> int:
    """The bands on at a step: one more every 1000 iterations."""
    return min(int(step) // 1000, degree)


def sh_color(means: torch.Tensor, centre: torch.Tensor, dc: torch.Tensor, rest: torch.Tensor,
             degree: int) -> torch.Tensor:
    """RGB [N, 3] of SH coefficients (dc [N, 3], rest [N, K - 1, 3]) along
    the camera -> mean direction, bands up to `degree`, + 0.5, >= 0."""
    d = means - centre
    d = d / d.norm(dim=-1, keepdim=True).clamp(min=1e-12)
    b = sh_basis(d, degree)  # [N, k]
    coef = torch.cat([dc[:, None, :], rest[:, : b.shape[1] - 1]], 1)  # [N, k, 3]
    return (mm(b[:, None, :], coef)[:, 0] + 0.5).clamp(min=0.0)


def initial_state(scene) -> dict:
    """The snapshot's Gaussians and Adam state, from the scene."""
    p = {k: getattr(scene, k.split(".")[1]).detach().clone() for k in LEAVES}
    count = {k: scene.alive.float() * scene.adam_count for k in p}
    return {"params": p, "mu": {k: torch.zeros_like(v) for k, v in p.items()},
            "nu": {k: scene.adam_nu[k].clone() for k in p}, "count": count, "step": scene.adam_count}


def render(scene, p: Dict[str, torch.Tensor], view, *, step: int, white_background: bool = False,
           count: bool = False, alive=None):
    """One view of the static cloud: {"rgb", "depth", "acc", "T",
    "radius"} and, with count, the blend's pair counts; the SH bands of
    `step` (active_degree) on."""
    dev = p["gaussians.xyz"].device
    visible = scene.alive if alive is None else alive
    g = dict(means=p["gaussians.xyz"], rots=quat_rotmat(p["gaussians.rot"]),
             scales=torch.exp(p["gaussians.log_scale"]), opacity=torch.sigmoid(p["gaussians.opacity_logit"])[:, 0],
             dc=p["gaussians.feat_dc"][:, 0], visible=visible)
    s = project(scene, g, p["gaussians.feat_rest"], view)  # its degree-1 rgb is replaced below
    c2w = torch.linalg.inv(torch.tensor(view.w2c, dtype=torch.float64))
    centre = c2w[:3, 3].float().to(dev)
    degree = active_degree(step, scene.cfg["sh_degree"])
    s["rgb"] = sh_color(g["means"], centre, g["dc"], p["gaussians.feat_rest"], degree)
    feats = torch.cat([s["rgb"], s["depth"][:, None]], -1)
    bg = torch.full((3,), 1.0 if white_background else 0.0, device=dev)
    img, counts = rasterize(s, feats, bg, count=count)
    img = img[: scene.H, : scene.W]
    Tr = img[..., 4]
    out = {"rgb": img[..., :3] + Tr[..., None] * bg, "depth": img[..., 3], "acc": 1.0 - Tr, "T": Tr,
           "radius": s["radius"]}
    if count:
        out["counts"] = counts
        out["alive_rows"] = int(visible.sum())
    return out


def loss_of(out: dict, image: torch.Tensor, optim: dict, half: bool = False) -> torch.Tensor:
    """3DGS's objective on one view. half: a planted fault, the loss over
    the top half of the image's rows only."""
    img, gt = out["rgb"], image
    if half:
        img, gt = img[: img.shape[0] // 2], gt[: gt.shape[0] // 2]
    l1 = (img - gt).abs().mean()
    return (1 - optim["lambda_dssim"]) * optim["lambda_l1"] * l1 + optim["lambda_dssim"] * (1 - ssim(img, gt))


def learning_rates(scene, optim: dict, step: int) -> Dict[str, float]:
    t = min(max(step / optim["position_lr_max_steps"], 0.0), 1.0)
    ext = scene.scene_radius
    xyz = math.exp(math.log(optim["position_lr_init"] * ext) * (1 - t)
                   + math.log(optim["position_lr_final"] * ext) * t)
    return {"gaussians.xyz": xyz, "gaussians.feat_dc": optim["feature_lr"],
            "gaussians.feat_rest": optim["feature_lr"] / 20,
            "gaussians.log_scale": optim["scaling_lr"], "gaussians.rot": optim["rotation_lr"],
            "gaussians.opacity_logit": optim["opacity_lr"], "gaussians.semantic": optim["semantic_lr"]}


def step(scene, state: dict, recipe: dict, view, image: torch.Tensor, half: bool = False):
    """One training step on one view; returns (new state, loss, {leaf:
    gradient}). half: see loss_of."""
    p = {k: v.detach().requires_grad_(True) for k, v in state["params"].items()}
    wb = recipe["data"].get("white_background", False)
    out = render(scene, p, view, step=state["step"], white_background=wb)
    loss = loss_of(out, image, recipe["optim"], half)
    names = list(p)
    grads = torch.autograd.grad(loss, [p[k] for k in names], allow_unused=True)
    grads = {k: (torch.zeros_like(p[k]) if g is None else g) for k, g in zip(names, grads)}
    new = ref_adam.step(state, grads, scene.alive, learning_rates(scene, recipe["optim"], state["step"]))
    return new, loss.detach(), grads
