"""The benchmark's unbounded 360-degree scene, made on the device from a
seed: the shape of an outdoor Mip-NeRF 360 capture (`garden`).

A round table with an object on it at the world origin (z up), a
ground disk around it, a ring of shrubs and trees, and a far backdrop
(a sphere of ~100 m around everything, so that every ray ends on a
surface, as in a capture whose background the Gaussians cover). The
cameras orbit the table at the configuration's radius and height,
looking in. One static cloud of Gaussians (3D Gaussian splatting: no
actors, no sky model), SH colour of the configuration's degree.

Everything is drawn from one torch.Generator on the device, in a few
large calls, so the same seed gives the same scene on the same device.
The ground truth is not rendered by the program: each view's image
comes from casting its rays against the same analytic surfaces (planes,
disks, spheres, vertical cylinders) and colouring the nearest hit with
the same procedural texture that coloured the Gaussians, so the
Gaussians sit near the ground truth, as in a scene mid-training.

The sizes come from the configuration file (`scene` section). The
scene holds plain tensors and numpy arrays, as harness/scene.py's
street does: `harness/orbit.py` turns them into the program's objects
and `reference/sh.py` reads them as they are.
"""

from __future__ import annotations

import copy
import dataclasses
import math
from typing import Dict, List

import numpy as np
import torch

from benchmark.harness.scene import SH_C0, View, _quat_mul, _rand, _randn, make_generator

# surface kinds, for the texture
GROUND, WOOD, BARK, VASE, SHRUB, CANOPY, BACKDROP = range(7)


@dataclasses.dataclass
class Models:
    """One model, the background, over the whole table."""

    names: List[str]
    slices: np.ndarray  # [1, 2]


@dataclasses.dataclass
class OrbitScene:
    cfg: dict  # the configuration's `scene` section
    H: int
    W: int
    K: np.ndarray  # [3, 3] float64
    views: List[View]
    train_views: List[int]
    models: Models
    capacity: int
    # Gaussian rows [C, ...] (float32 on the device)
    xyz: torch.Tensor
    feat_dc: torch.Tensor  # [C, 1, 3]
    feat_rest: torch.Tensor  # [C, (sh_degree + 1)^2 - 1, 3]
    log_scale: torch.Tensor
    rot: torch.Tensor  # [C, 4] (w, x, y, z), not normalised
    opacity_logit: torch.Tensor  # [C, 1]
    semantic: torch.Tensor  # [C, 1]
    alive: torch.Tensor  # [C] bool
    model_id: torch.Tensor  # [C] int64, all 0
    # the analytic surfaces: spheres [S, 4] (centre, radius) with a kind
    # and an index each, vertical cylinders [Y, 4] (x, y, radius, top z)
    spheres: torch.Tensor
    sphere_kind: torch.Tensor  # [S] int64
    cylinders: torch.Tensor
    cylinder_kind: torch.Tensor  # [Y] int64
    adam_nu: Dict[str, torch.Tensor]
    adam_count: int
    scene_center: np.ndarray  # the cameras' nerf++ centre and radius (the spatial learning-rate scale)
    scene_radius: float
    sphere_center: np.ndarray  # the cloud's bounding sphere
    sphere_radius: float


def look_at_w2c(pos: np.ndarray, target: np.ndarray) -> np.ndarray:
    """World -> camera (OpenCV: x right, y down, z forward) of a camera
    at pos looking at target, z up."""
    fwd = target - pos
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(fwd, [0.0, 0.0, 1.0])
    right = right / np.linalg.norm(right)
    down = np.cross(fwd, right)
    c2w = np.eye(4)
    c2w[:3, :3] = np.stack([right, down, fwd], axis=1)
    c2w[:3, 3] = pos
    return np.linalg.inv(c2w)


def make_views(cfg: dict):
    """The orbit's views in capture order and the training views (every
    split_test-th held out, 3DGS's --eval): (W, H, K, views, train)."""
    W, H = cfg["image_size"]
    K = np.array([[cfg["fx"], 0.0, W / 2.0], [0.0, cfg["fx"], H / 2.0], [0.0, 0.0, 1.0]])
    n = cfg["views"]
    r0, r1 = cfg["orbit_radius"]
    h0, h1 = cfg["orbit_height"]
    target = np.array(cfg["look_at"], np.float64)
    views, train = [], []
    split = cfg.get("split_test", -1)
    for i in range(n):
        a = 2.0 * math.pi * i / n
        r = r0 + (r1 - r0) * 0.5 * (1.0 + math.sin(3.0 * a))
        h = h0 + (h1 - h0) * 0.5 * (1.0 + math.sin(2.0 * a + 1.0))
        pos = np.array([r * math.cos(a), r * math.sin(a), h])
        aim = target + 0.15 * np.array([math.sin(5.0 * a), math.cos(7.0 * a), 0.3 * math.sin(4.0 * a)])
        v = View(i, i, i, 0, i, look_at_w2c(pos, aim), np.eye(4))
        if split <= 0 or i % split != 0:
            train.append(i)
        views.append(v)
    return W, H, K, views, train


def _hash(x: torch.Tensor) -> torch.Tensor:
    return torch.frac(torch.sin(x * 12.9898 + 4.1414) * 43758.5453).abs()


def surface_color(p: torch.Tensor, kind: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """RGB [N, 3] in [0.02, 0.98] of points p [N, 3] on surfaces of
    `kind` (the module's constants), index: the primitive's number (a
    shrub's or tree's own hue)."""
    x, y, z = p.unbind(-1)
    h = _hash(index.to(p.dtype))
    r = torch.sqrt(x * x + y * y)
    tex = torch.sin(7.3 * x + 2.1 * y) * torch.sin(5.7 * y - 1.3 * x)
    grass = torch.stack([0.26 + 0.06 * tex, 0.42 + 0.08 * tex + 0.05 * torch.sin(0.7 * r), 0.16 + 0.04 * tex], -1)
    grain = 0.06 * torch.sin(40.0 * x + 3.0 * torch.sin(9.0 * y))
    wood = torch.stack([0.55 + grain, 0.38 + grain, 0.22 + 0.5 * grain], -1)
    ring = 0.05 * torch.sin(23.0 * z + 6.0 * torch.atan2(y, x))
    bark = torch.stack([0.33 + ring, 0.24 + ring, 0.15 + ring], -1)
    band = torch.sin(30.0 * z)
    vase = torch.stack([0.78 + 0.1 * band, 0.42 + 0.15 * band, 0.26 + 0.05 * band], -1)
    leaf = 0.05 * torch.sin(31.0 * x + 17.0 * z) * torch.sin(29.0 * y - 13.0 * z)
    shrub = torch.stack([0.12 + 0.10 * h + leaf, 0.30 + 0.12 * h + leaf, 0.10 + 0.05 * h + leaf], -1)
    canopy = torch.stack([0.20 + 0.15 * h + leaf, 0.38 + 0.12 * h + leaf, 0.12 + 0.04 * h + leaf], -1)
    # the backdrop: a treeline below ~15 degrees of elevation, sky above
    e = z / torch.sqrt(x * x + y * y + z * z).clamp(min=1e-6)
    az = torch.atan2(y, x)
    line = 0.10 + 0.06 * torch.sin(5.0 * az) + 0.03 * torch.sin(23.0 * az)
    cloud = 0.05 * torch.sin(6.0 * x / 100.0 + 4.0 * z / 100.0) * torch.sin(9.0 * y / 100.0)
    sky = torch.stack([0.55 + 0.25 * e + cloud, 0.68 + 0.18 * e + cloud, 0.90 + 0.05 * e + cloud], -1)
    trees = torch.stack([0.18 + 0.2 * tex.abs() * 0.3, 0.26 + 0.05 * tex, 0.17 + 0.03 * tex], -1)
    backdrop = torch.where((e < line)[:, None], trees, sky)
    out = torch.stack([grass, wood, bark, vase, shrub, canopy, backdrop])  # [7, N, 3]
    pick = kind.long().clamp(0, BACKDROP)
    return out.gather(0, pick[None, :, None].expand(1, -1, 3))[0].clamp(0.02, 0.98)


def _uniform_sphere(g, n):
    d = _randn(g, n, 3)
    return d / d.norm(dim=-1, keepdim=True).clamp(min=1e-12)


def _align_z(n: torch.Tensor) -> torch.Tensor:
    """Quaternions (w, x, y, z) turning the z axis onto unit normals n."""
    x, y, z = n.unbind(-1)
    q = torch.stack([1.0 + z, -y, x, torch.zeros_like(z)], -1)
    flip = torch.tensor([0.0, 1.0, 0.0, 0.0], device=n.device).expand_as(q)
    q = torch.where((z < -0.999999)[:, None], flip, q)
    return q / q.norm(dim=-1, keepdim=True)


def _layout(cfg: dict, g: torch.Generator):
    """The primitives of the garden, from the generator: spheres (the
    object, the shrubs, the canopies) and vertical cylinders (the
    table's pedestal, the trunks)."""
    dev = g.device
    t, sh, tr = cfg["table"], cfg["shrubs"], cfg["trees"]
    obj = torch.tensor([[0.0, 0.0, t["height"] + cfg["object"]["radius"], cfg["object"]["radius"]]], device=dev)
    ns, nt = sh["count"], tr["count"]
    a = 2.0 * math.pi * (torch.arange(ns, device=dev) + 0.8 * _rand(g, ns)) / ns
    rr = sh["ring"][0] + (sh["ring"][1] - sh["ring"][0]) * _rand(g, ns)
    rad = sh["radius"][0] + (sh["radius"][1] - sh["radius"][0]) * _rand(g, ns)
    shrubs = torch.stack([rr * torch.cos(a), rr * torch.sin(a), 0.6 * rad, rad], -1)
    a = 2.0 * math.pi * (torch.arange(nt, device=dev) + 0.8 * _rand(g, nt)) / nt + 0.3
    rr = tr["ring"][0] + (tr["ring"][1] - tr["ring"][0]) * _rand(g, nt)
    rad = tr["canopy_radius"][0] + (tr["canopy_radius"][1] - tr["canopy_radius"][0]) * _rand(g, nt)
    hc = tr["canopy_height"][0] + (tr["canopy_height"][1] - tr["canopy_height"][0]) * _rand(g, nt)
    canopies = torch.stack([rr * torch.cos(a), rr * torch.sin(a), hc, rad], -1)
    spheres = torch.cat([obj, shrubs, canopies])
    sphere_kind = torch.cat([torch.full((1,), VASE), torch.full((ns,), SHRUB), torch.full((nt,), CANOPY)]).to(dev)
    ped = torch.tensor([[0.0, 0.0, t["pedestal_radius"], t["height"] - t["thickness"]]], device=dev)
    trunks = torch.stack([canopies[:, 0], canopies[:, 1], torch.full((nt,), tr["trunk_radius"], device=dev),
                          canopies[:, 2]], -1)
    cylinders = torch.cat([ped, trunks])
    cylinder_kind = torch.cat([torch.full((1,), WOOD), torch.full((nt,), BARK)]).to(dev)
    return spheres, sphere_kind, cylinders, cylinder_kind


def _pick(g, weights: torch.Tensor, n: int) -> torch.Tensor:
    return torch.multinomial(weights / weights.sum(), n, replacement=True, generator=g)


def _points(cfg: dict, g: torch.Generator, spheres, sphere_kind, cylinders):
    """The alive Gaussians' centres on the surfaces: (xyz [N, 3], unit
    normal [N, 3], kind [N], primitive index [N], spacing [N]: the
    square root of the surface area a Gaussian of its group covers)."""
    dev = g.device
    parts = []

    def add(xyz, nrm, kind, index, area):
        n = xyz.shape[0]
        parts.append((xyz, nrm, torch.full((n,), kind, device=dev) if isinstance(kind, int) else kind,
                      index, torch.full((n,), math.sqrt(area / max(n, 1)), device=dev)))

    up = torch.tensor([0.0, 0.0, 1.0], device=dev)
    # ground: a dense inner disk where the cameras are close, the rest thinner
    gr = cfg["ground"]
    n_in = int(gr["rows"] * gr["inner_share"])
    for n, (r0, r1) in ((n_in, (0.0, gr["inner_radius"])), (gr["rows"] - n_in, (gr["inner_radius"], gr["radius"]))):
        r = torch.sqrt(r0 * r0 + (r1 * r1 - r0 * r0) * _rand(g, n))
        a = 2.0 * math.pi * _rand(g, n)
        xyz = torch.stack([r * torch.cos(a), r * torch.sin(a), torch.zeros_like(r)], -1)
        add(xyz, up.expand(n, 3), GROUND, torch.zeros(n, device=dev), math.pi * (r1 * r1 - r0 * r0))
    # the table: its top, its rim and its pedestal
    t = cfg["table"]
    n = t["rows"]
    n_top, n_rim = int(0.7 * n), int(0.12 * n)
    n_ped = n - n_top - n_rim
    R, h, th = t["radius"], t["height"], t["thickness"]
    r = R * torch.sqrt(_rand(g, n_top))
    a = 2.0 * math.pi * _rand(g, n_top)
    add(torch.stack([r * torch.cos(a), r * torch.sin(a), torch.full_like(r, h)], -1), up.expand(n_top, 3), WOOD,
        torch.zeros(n_top, device=dev), math.pi * R * R)
    for count, (cx, cy, rad, z0, z1), kind in ((n_rim, (0.0, 0.0, R, h - th, h), WOOD),
                                              (n_ped, (0.0, 0.0, t["pedestal_radius"], 0.0, h - th), WOOD)):
        a = 2.0 * math.pi * _rand(g, count)
        z = z0 + (z1 - z0) * _rand(g, count)
        nrm = torch.stack([torch.cos(a), torch.sin(a), torch.zeros_like(a)], -1)
        add(torch.stack([cx + rad * nrm[:, 0], cy + rad * nrm[:, 1], z], -1), nrm, kind,
            torch.zeros(count, device=dev), 2.0 * math.pi * rad * (z1 - z0))
    # spheres: the object, the shrubs and the canopies, each group's rows
    # over its spheres by area; their lower halves under the ground mirrored up
    groups = ((VASE, cfg["object"]["rows"]), (SHRUB, cfg["shrubs"]["rows"]),
              (CANOPY, int(cfg["trees"]["rows"] * (1.0 - cfg["trees"]["trunk_share"]))))
    for kind, n in groups:
        idx = (sphere_kind == kind).nonzero()[:, 0]
        sp = spheres[idx]
        k = _pick(g, sp[:, 3] ** 2, n)
        d = _uniform_sphere(g, n)
        c, rad = sp[k, :3], sp[k, 3]
        below = c[:, 2] + rad * d[:, 2] < 0.0
        d = torch.where(below[:, None], d * torch.tensor([1.0, 1.0, -1.0], device=dev), d)
        add(c + rad[:, None] * d, d, kind, idx[k].to(torch.float32), float((4.0 * math.pi * sp[:, 3] ** 2).sum()))
    # the trunks, up to their canopy's centre
    n = cfg["trees"]["rows"] - groups[2][1]
    cy = cylinders[1:]
    k = _pick(g, cy[:, 3], n)
    a = 2.0 * math.pi * _rand(g, n)
    nrm = torch.stack([torch.cos(a), torch.sin(a), torch.zeros_like(a)], -1)
    z = cy[k, 3] * _rand(g, n)
    add(torch.stack([cy[k, 0] + cy[k, 2] * nrm[:, 0], cy[k, 1] + cy[k, 2] * nrm[:, 1], z], -1), nrm, BARK,
        k.to(torch.float32), float((2.0 * math.pi * cy[:, 2] * cy[:, 3]).sum()))
    # the backdrop: a sphere around everything, seen from inside
    b = cfg["backdrop"]
    n = b["rows"]
    d = _uniform_sphere(g, n)
    add(b["radius"] * d, -d, BACKDROP, torch.zeros(n, device=dev), 4.0 * math.pi * b["radius"] ** 2)
    return [torch.cat([p[i] for p in parts]) for i in range(5)]


def nerfpp_norm(centres: np.ndarray):
    """NeRF++'s scene norm of the camera centres (3DGS's
    getNerfppNorm): their mean, 1.1 times the largest distance to it."""
    c = centres.mean(axis=0)
    return c, float(np.linalg.norm(centres - c[None], axis=-1).max()) * 1.1


def make_scene(cfg: dict, seed: int, device, iteration=None) -> OrbitScene:
    """The configuration's garden at its snapshot iteration (or
    `iteration`: Adam's step counts), from `seed`, on `device`."""
    dev = torch.device(device)
    g = make_generator(seed, dev, stream=0)
    W, H, K, views, train = make_views(cfg)
    C, N = cfg["rows"]["capacity"], cfg["rows"]["alive"]
    sh_k = (cfg["sh_degree"] + 1) ** 2
    spheres, sphere_kind, cylinders, cylinder_kind = _layout(cfg, g)
    pts, nrm, kind, index, spacing = _points(cfg, g, spheres, sphere_kind, cylinders)
    if pts.shape[0] != N:
        raise ValueError(f"the scene's groups hold {pts.shape[0]} rows, the configuration says {N} alive")
    pts = pts + 0.002 * _randn(g, N, 3)
    rgb = surface_color(pts, kind, index) + 0.03 * _randn(g, N, 3)
    # flat Gaussians on their surface, their footprint the group's spacing
    # times the overlap of a trained cloud
    s_t = cfg["overlap"] * spacing[:, None] * torch.exp(0.35 * _randn(g, N, 2))
    s_n = cfg["thickness"] * spacing[:, None] * torch.exp(0.3 * _randn(g, N, 1))
    ang = math.pi * _rand(g, N)
    spin = torch.stack([torch.cos(ang / 2), 0 * ang, 0 * ang, torch.sin(ang / 2)], -1)
    rot_n = _quat_mul(_align_z(nrm), spin) + 0.04 * _randn(g, N, 4)

    # the live rows sit between pruned ones, as after densification
    slot = torch.randperm(C, generator=g, device=dev)[:N]
    alive = torch.zeros(C, dtype=torch.bool, device=dev)
    alive[slot] = True
    xyz = torch.zeros((C, 3), device=dev)
    log_scale = torch.full((C, 3), -10.0, device=dev)
    rot = torch.zeros((C, 4), device=dev)
    rot[:, 0] = 1.0
    col = torch.zeros((C, 3), device=dev)
    xyz[slot], log_scale[slot], rot[slot], col[slot] = pts, torch.log(torch.cat([s_t, s_n], -1)), rot_n, rgb.clamp(0, 1)
    feat_dc = ((col - 0.5) / SH_C0)[:, None, :].contiguous()
    feat_rest = cfg["feat_rest_std"] * _randn(g, C, sh_k - 1, 3)
    op = cfg["opacity_logit_mean"] + cfg["opacity_logit_std"] * _randn(g, C, 1)
    op = torch.where(_rand(g, C, 1) < cfg["faint_share"], torch.full_like(op, -6.0), op)
    dead = ~alive
    feat_dc[dead] = 0.0
    feat_rest[dead] = 0.0
    op[dead] = -10.0

    nu_scale = cfg["adam_nu_scale"]
    leaves = {"gaussians.xyz": xyz, "gaussians.feat_dc": feat_dc, "gaussians.feat_rest": feat_rest,
              "gaussians.log_scale": log_scale, "gaussians.rot": rot, "gaussians.opacity_logit": op,
              "gaussians.semantic": torch.zeros((C, 1), device=dev)}
    adam_nu = {}
    for k, t in leaves.items():
        nu = (nu_scale.get(k, 0.0) * _randn(g, *t.shape)) ** 2
        adam_nu[k] = torch.where(alive.reshape((C,) + (1,) * (t.dim() - 1)), nu, 0.0)

    centres = np.stack([np.linalg.inv(v.w2c)[:3, 3] for v in views])
    centre, radius = nerfpp_norm(centres)
    lo, hi = pts.min(0).values.double().cpu().numpy(), pts.max(0).values.double().cpu().numpy()
    return OrbitScene(
        cfg=cfg, H=H, W=W, K=K, views=views, train_views=train,
        models=Models(names=["background"], slices=np.array([[0, C]], np.int64)), capacity=C,
        xyz=xyz, feat_dc=feat_dc, feat_rest=feat_rest, log_scale=log_scale, rot=rot, opacity_logit=op,
        semantic=torch.zeros((C, 1), device=dev), alive=alive, model_id=torch.zeros(C, dtype=torch.int64, device=dev),
        spheres=spheres, sphere_kind=sphere_kind, cylinders=cylinders, cylinder_kind=cylinder_kind,
        adam_nu=adam_nu, adam_count=cfg["snapshot_iteration"] if iteration is None else int(iteration),
        scene_center=centre, scene_radius=radius,
        sphere_center=(lo + hi) / 2.0, sphere_radius=float(np.linalg.norm(hi - lo) / 2.0),
    )


# ---- ground truth ----


@dataclasses.dataclass
class Truth:
    """One view's supervision, [H, W, ...] on the device."""

    image: torch.Tensor  # [H, W, 3] float32


def view_rays(scene: OrbitScene, view: View, device):
    """World-space ray origin [3] and unit directions [H W, 3] through the
    pixel centres (float64)."""
    dev = torch.device(device)
    c2w = np.linalg.inv(view.w2c)
    ys, xs = torch.meshgrid(torch.arange(scene.H, device=dev, dtype=torch.float64) + 0.5,
                            torch.arange(scene.W, device=dev, dtype=torch.float64) + 0.5, indexing="ij")
    K = scene.K
    d_cam = torch.stack([(xs - K[0, 2]) / K[0, 0], (ys - K[1, 2]) / K[1, 1], torch.ones_like(xs)], -1).reshape(-1, 3)
    d = d_cam @ torch.tensor(c2w[:3, :3].T, device=dev)
    return torch.tensor(c2w[:3, 3], device=dev), d / d.norm(dim=-1, keepdim=True)


def _nearest(best, kind, index, t, ok, k, i):
    ok = ok & (t > 1e-6) & (t < best)
    return (torch.where(ok, t, best), torch.where(ok, k if torch.is_tensor(k) else torch.full_like(kind, k), kind),
            torch.where(ok, i if torch.is_tensor(i) else torch.full_like(index, i), index))


def make_truth(scene: OrbitScene, view: View, device, chunk: int = 1 << 18) -> Truth:
    """Cast the view's rays against the garden's surfaces and colour the
    nearest hit (every ray ends on the backdrop at the latest)."""
    cfg = scene.cfg
    dev = torch.device(device)
    o, d_all = view_rays(scene, view, dev)
    sp = scene.spheres.double()
    cy = scene.cylinders.double()
    t_cfg = cfg["table"]
    out = []
    for d in torch.split(d_all, chunk):
        n = d.shape[0]
        best = torch.full((n,), float("inf"), dtype=torch.float64, device=dev)
        kind = torch.full((n,), BACKDROP, dtype=torch.int64, device=dev)
        index = torch.zeros(n, dtype=torch.float64, device=dev)
        # the backdrop sphere around the origin, from inside: the far root
        R = cfg["backdrop"]["radius"]
        bq = (o * d).sum(-1)
        best = -bq + torch.sqrt((bq * bq - (o * o).sum() + R * R).clamp(min=0.0))
        # the ground disk and the table's top
        tz = torch.where(d[:, 2].abs() > 1e-12, d[:, 2], torch.full_like(d[:, 2], 1e-12))
        for z0, rad, k in ((0.0, cfg["ground"]["radius"], GROUND), (t_cfg["height"], t_cfg["radius"], WOOD)):
            t = (z0 - o[2]) / tz
            p = o + t[:, None] * d
            best, kind, index = _nearest(best, kind, index, t, p[:, 0] ** 2 + p[:, 1] ** 2 <= rad * rad, k, 0.0)
        # spheres: the nearest root outside, then the far one (an object seen from inside it has none)
        oc = o[None, :] - sp[:, :3]  # [S, 3]
        b = d @ oc.t()  # [n, S]
        c = (oc * oc).sum(-1) - sp[:, 3] ** 2
        disc = b * b - c[None, :]
        root = torch.sqrt(disc.clamp(min=0.0))
        t = torch.where(-b - root > 1e-6, -b - root, -b + root)
        t = torch.where(disc >= 0, t, torch.full_like(t, float("inf")))
        p_z = o[2] + t * d[:, 2:3]
        t = torch.where(p_z >= 0.0, t, torch.full_like(t, float("inf")))  # the halves under the ground are cut
        tmin, arg = t.min(dim=1)
        best, kind, index = _nearest(best, kind, index, tmin, torch.isfinite(tmin), scene.sphere_kind[arg],
                                     arg.to(torch.float64))
        # vertical cylinders from z 0 to their top, and the table's rim
        rims = torch.cat([cy, torch.tensor([[0.0, 0.0, t_cfg["radius"], t_cfg["height"]]], dtype=torch.float64,
                                           device=dev)])
        lo_z = torch.cat([torch.zeros(cy.shape[0], dtype=torch.float64, device=dev),
                          torch.tensor([t_cfg["height"] - t_cfg["thickness"]], dtype=torch.float64, device=dev)])
        rk = torch.cat([scene.cylinder_kind, torch.tensor([WOOD], device=dev)])
        ox, oy = o[0] - rims[:, 0], o[1] - rims[:, 1]  # [Y]
        a = (d[:, 0] ** 2 + d[:, 1] ** 2).clamp(min=1e-18)[:, None]
        bb = d[:, 0:1] * ox[None, :] + d[:, 1:2] * oy[None, :]
        cc = (ox * ox + oy * oy - rims[:, 2] ** 2)[None, :]
        disc = bb * bb - a * cc
        root = torch.sqrt(disc.clamp(min=0.0))
        t = (-bb - root) / a
        z = o[2] + t * d[:, 2:3]
        ok = (disc >= 0) & (z >= lo_z[None, :]) & (z <= rims[:, 3][None, :]) & (t > 1e-6)
        t = torch.where(ok, t, torch.full_like(t, float("inf")))
        tmin, arg = t.min(dim=1)
        cyl_index = torch.where(arg < cy.shape[0], arg - 1, torch.zeros_like(arg)).clamp(min=0)
        best, kind, index = _nearest(best, kind, index, tmin, torch.isfinite(tmin), rk[arg],
                                     cyl_index.to(torch.float64))
        p = o + best[:, None] * d
        out.append(surface_color(p.float(), kind, index.float()))
    return Truth(image=torch.cat(out).reshape(scene.H, scene.W, 3).contiguous())


GROUPS = ("ground", "table", "object", "shrubs", "trees", "backdrop")


def toy_config(cfg: dict, width: int = 160, rows: int = 6000, views: int = 17) -> dict:
    """The configuration's `scene` section at a size the CPU runs in
    seconds (tests): `width` px wide images (the same field of view),
    `views` cameras, about `rows` alive rows shared as the groups share
    them, 8 shrubs and 6 trees; the rest as the file has it."""
    s = copy.deepcopy(cfg)
    W, H = s["image_size"]
    s.update(image_size=[width, round(width * H / W)], fx=s["fx"] * width / W, views=views)
    total = sum(s[k]["rows"] for k in GROUPS)
    for k in GROUPS:
        s[k]["rows"] = int(rows * s[k]["rows"] / total)
    alive = sum(s[k]["rows"] for k in GROUPS)
    s["rows"] = {"capacity": alive * 3 // 2, "alive": alive}
    s["shrubs"]["count"], s["trees"]["count"] = 8, 6
    return s
