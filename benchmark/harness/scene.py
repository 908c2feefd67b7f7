"""The benchmark's street scene, made on the device from a seed.

One generator serves every configuration: a straight street along the
world x axis (z up), an ego vehicle driving down it, cameras mounted on
the ego vehicle, a static background of Gaussians on the road and on the
building facades, tracked actors (cars) driving in the lanes, and a sky
cubemap. Everything is drawn from one torch.Generator on the device, in
a few large calls, so the same seed gives the same scene on the same
device.

The ground truth is not rendered by the program: each view's image,
sky mask, LiDAR depth and actor boxes come from casting the view's rays
against the same analytic street (road plane, facades, a far wall,
the actors' boxes) and colouring the hits with the same procedural
texture that coloured the Gaussians. So the Gaussians sit near the
ground truth, as in a scene mid-training, and the gradients have the
size of such a scene's.

The sizes come from the configuration file (`scene` section); nothing
here is specific to one configuration. The scene holds plain tensors
and numpy arrays: `harness/program.py` turns them into the program's
objects and `reference/` reads them as they are.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional

import numpy as np
import torch

SH_C0 = 0.28209479177387814


@dataclasses.dataclass
class View:
    """One camera image of the sequence (host values)."""

    index: int  # position in the scene's list of views
    frame: int  # dataset frame number
    frame_idx: int  # row of the tracklet table (frame - first frame)
    cam: int  # sensor index into the configuration's cameras
    image_id: int
    w2c: np.ndarray  # [4, 4] float64 world -> camera (OpenCV axes)
    ego_pose: np.ndarray  # [4, 4] float64 ego -> world


@dataclasses.dataclass
class Models:
    """Row layout of the packed Gaussian table: model 0 the background,
    then the actors."""

    names: List[str]
    slices: np.ndarray  # [M, 2] int64 row ranges
    start_frame: np.ndarray  # [M] int
    end_frame: np.ndarray  # [M] int
    extent: np.ndarray  # [M] float: the spatial learning-rate scale
    track_id: np.ndarray  # [M] int (-1 background)
    box_half: np.ndarray  # [M, 3] float (0 for the background)
    flip_prob: np.ndarray  # [M] float


@dataclasses.dataclass
class StreetScene:
    cfg: dict  # the configuration's `scene` section
    H: int
    W: int
    K: np.ndarray  # [3, 3] float64 intrinsics at the loaded size
    views: List[View]
    train_views: List[int]  # indices into views
    models: Models
    capacity: int
    # Gaussian rows [C, ...] (float32 on the device)
    xyz: torch.Tensor
    feat_dc: torch.Tensor  # [C, fourier_dim, 3]
    feat_rest: torch.Tensor  # [C, (sh_degree + 1)^2 - 1, 3]
    log_scale: torch.Tensor
    rot: torch.Tensor  # [C, 4] (w, x, y, z), not normalised
    opacity_logit: torch.Tensor  # [C, 1]
    semantic: torch.Tensor  # [C, 1]
    alive: torch.Tensor  # [C] bool
    model_id: torch.Tensor  # [C] int64
    # tracklets over the frames: [F, O, 3] ego-frame positions, [F, O, 4]
    # ego-frame quaternions, the learnable residuals, actor a in column a
    track_trans: torch.Tensor
    track_rots: torch.Tensor
    opt_trans: torch.Tensor
    opt_rots: torch.Tensor  # [F, O, 1]
    # actors' world boxes per frame, for the ground truth: [F, A, 3]
    # centres, [F, A] yaws, [A, 3] half sizes, [A, 3] colours
    actor_world: torch.Tensor
    actor_yaw: torch.Tensor
    actor_colors: torch.Tensor
    sky_cubemap: torch.Tensor  # [3, 6 R R]
    # Adam's second moments at the snapshot, per parameter name
    adam_nu: Dict[str, torch.Tensor]
    adam_count: int
    scene_radius: float
    sphere_center: np.ndarray
    sphere_radius: float


def make_generator(seed: int, device, stream: int = 0) -> torch.Generator:
    """A generator on `device` for `seed` (any integer the command line
    takes) and a stream number, so that the scene, the draws of the steps
    and the order of the views come from separate streams of one seed."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + stream * 7_919 + 12_345) % (2**63))
    return g


def _rand(g, *shape):
    return torch.rand(shape, generator=g, device=g.device)


def _randn(g, *shape):
    return torch.randn(shape, generator=g, device=g.device)


def camera_size(cfg: dict):
    """(W, H, scale) of the loaded images: the source width capped at
    `width_cap`, the height rounded the same way (the port's loader)."""
    w0, h0 = cfg["image_size_source"]
    scale = min(1.0, cfg["width_cap"] / w0)
    return int(round(w0 * scale)), int(round(h0 * scale)), scale


def yaw_rotmat(yaw: float) -> np.ndarray:
    c, s = math.cos(yaw), math.sin(yaw)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


def ego_pose(cfg: dict, frame_idx: int) -> np.ndarray:
    """The ego vehicle's pose at a frame: down the street at
    `ego_speed` metres a frame, weaving gently in yaw."""
    x = cfg["street_start"] + cfg["ego_speed"] * frame_idx
    yaw = cfg["ego_weave"] * math.sin(2.0 * math.pi * frame_idx / 200.0)
    pose = np.eye(4)
    pose[:3, :3] = yaw_rotmat(yaw)
    pose[:3, 3] = [x, 0.3 * math.sin(2.0 * math.pi * frame_idx / 150.0), 0.0]
    return pose


def camera_w2c(cfg: dict, pose: np.ndarray, cam: dict) -> np.ndarray:
    """World -> camera (OpenCV: x right, y down, z forward) of a camera
    mounted at cfg's height with a yaw on the ego vehicle."""
    yaw = math.radians(cam["yaw_deg"])
    fwd = np.array([math.cos(yaw), math.sin(yaw), 0.0])
    right = np.array([math.sin(yaw), -math.cos(yaw), 0.0])
    down = np.array([0.0, 0.0, -1.0])
    c2e = np.eye(4)
    c2e[:3, :3] = np.stack([right, down, fwd], axis=1)
    c2e[:3, 3] = [cam.get("forward_m", 1.5), cam.get("left_m", 0.0), cfg["camera_height"]]
    return np.linalg.inv(pose @ c2e)


def make_views(cfg: dict):
    """Every view of the sequence, frame-major, and the indices of the
    training views (all, or every frame but each split_test-th)."""
    W, H, scale = camera_size(cfg)
    K = np.array([[cfg["fx_source"] * scale, 0.0, W / 2.0],
                  [0.0, cfg["fx_source"] * scale, H / 2.0],
                  [0.0, 0.0, 1.0]])
    first, last = cfg["frames"]
    views, train = [], []
    split = cfg.get("split_test", -1)
    for fi, frame in enumerate(range(first, last + 1)):
        pose = ego_pose(cfg, fi)
        for ci, cam in enumerate(cfg["cameras"]):
            v = View(len(views), frame, fi, ci, len(views), camera_w2c(cfg, pose, cam), pose)
            if split <= 0 or fi % split != 0:
                train.append(v.index)
            views.append(v)
    return W, H, K, views, train


# ---- the procedural street: surfaces and their texture ----


def building_height(cfg: dict, x: torch.Tensor, side: torch.Tensor) -> torch.Tensor:
    """Facade height of the building at street position x on side +-1:
    buildings `building_length` metres long, 6-14 m tall by a hash."""
    b = torch.floor(x / cfg["building_length"])
    h = torch.frac(torch.sin(b * 12.9898 + side * 78.233) * 43758.5453)
    return 6.0 + 8.0 * h.abs()


def street_color(cfg: dict, p: torch.Tensor, surface: torch.Tensor) -> torch.Tensor:
    """RGB [N, 3] in [0, 1] of points p [N, 3] on surface 0 (road and
    pavement), 1 (facade) or 2 (far wall)."""
    x, y, z = p.unbind(-1)
    half = cfg["road_half_width"]
    # road: asphalt with dashed lane marks, lighter pavement outside
    grain = 0.04 * torch.sin(3.1 * x + 1.7 * y) * torch.sin(2.3 * y - 0.7 * x)
    asphalt = 0.32 + grain
    lane = ((y.abs() < 0.09) & (torch.remainder(x, 6.0) < 3.0)) | ((y.abs() - half + 0.3).abs() < 0.08)
    road = torch.where(lane, torch.full_like(x, 0.88), asphalt)
    road = torch.where(y.abs() > half, 0.55 + 0.5 * grain, road)
    road_rgb = torch.stack([road, road, road * 1.02], -1)
    # facades: a colour a building, darker windows on a grid
    b = torch.floor(x / cfg["building_length"]) + 3.0 * torch.sign(y)
    hue = torch.frac(torch.sin(b * 91.7) * 4375.85).abs()
    base = torch.stack([0.45 + 0.35 * hue, 0.38 + 0.25 * (1 - hue), 0.30 + 0.2 * torch.cos(5 * hue) ** 2], -1)
    win = (torch.remainder(x, 3.0) < 1.6) & (torch.remainder(z, 3.2) > 1.0) & (torch.remainder(z, 3.2) < 2.4) & (z > 2.0)
    facade_rgb = torch.where(win[:, None], base * 0.35 + 0.1, base + 0.03 * torch.sin(7 * z)[:, None])
    far_rgb = torch.stack([0.55 + 0.05 * torch.sin(0.3 * y), 0.58 + 0.04 * torch.sin(0.4 * z), 0.62 + 0 * z], -1)
    out = torch.where((surface == 0)[:, None], road_rgb, torch.where((surface == 1)[:, None], facade_rgb, far_rgb))
    return out.clamp(0.02, 0.98)


def sky_color(d: torch.Tensor) -> torch.Tensor:
    """RGB of the sky in unit directions d [N, 3] (world, z up): blue
    overhead, paler toward the horizon, a faint band of cloud."""
    e = d[:, 2].clamp(-0.2, 1.0)
    t = (1.0 - e.clamp(min=0.0)) ** 3
    cloud = 0.06 * torch.sin(9.0 * d[:, 0] + 4.0 * d[:, 1]) * torch.sin(11.0 * e)
    r = 0.45 + 0.40 * t + cloud
    g = 0.62 + 0.28 * t + cloud
    b = 0.92 + 0.05 * t + cloud
    return torch.stack([r, g, b], -1).clamp(0.02, 0.98)


# ---- Gaussians ----


def _quat_mul(a, b):
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack([aw * bw - ax * bx - ay * by - az * bz, aw * bx + ax * bw + ay * bz - az * by,
                        aw * by - ax * bz + ay * bw + az * bx, aw * bz + ax * by - ay * bx + az * bw], -1)


def _background(cfg: dict, g: torch.Generator, n: int):
    """n background Gaussians: (xyz, rgb, log_scale, rot)."""
    fr = cfg["background_split"]
    n_road = int(n * fr["road"])
    n_far = int(n * fr["far"])
    n_fac = n - n_road - n_far
    x0, x1 = cfg["street_extent"]
    half_street = cfg["facade_offset"]
    dev = g.device
    # road and pavement, between the facades
    u = _rand(g, n_road, 2)
    road = torch.stack([x0 + (x1 - x0) * u[:, 0], (2 * u[:, 1] - 1) * half_street, torch.zeros(n_road, device=dev)], -1)
    # facades: side +-1, along x, up to the building's height
    u = _rand(g, n_fac, 3)
    side = torch.where(u[:, 0] < 0.5, -1.0, 1.0)
    fx = x0 + (x1 - x0) * u[:, 1]
    fz = building_height(cfg, fx, side) * u[:, 2]
    fac = torch.stack([fx, side * half_street, fz], -1)
    # far wall across the street's end
    u = _rand(g, n_far, 2)
    far = torch.stack([torch.full((n_far,), x1 + 8.0, device=dev), (2 * u[:, 0] - 1) * 3 * half_street,
                       cfg["far_height"] * u[:, 1]], -1)
    xyz = torch.cat([road, fac, far])
    surface = torch.cat([torch.zeros(n_road, device=dev), torch.ones(n_fac, device=dev),
                         torch.full((n_far,), 2.0, device=dev)])
    xyz = xyz + _randn(g, n, 3) * torch.tensor([0.01, 0.01, 0.01], device=dev)
    rgb = street_color(cfg, xyz, surface) + 0.03 * _randn(g, n, 3)
    # flat Gaussians on their surface: thin along its normal
    s_t, s_n = cfg["gaussian_scale_m"], cfg["gaussian_thickness_m"]
    tang = s_t * torch.exp(0.35 * _randn(g, n, 2))
    thin = s_n * torch.exp(0.3 * _randn(g, n, 1))
    scale = torch.cat([tang, thin], -1)
    far_rows = surface == 2
    scale = torch.where(far_rows[:, None], scale * cfg["far_scale_factor"], scale)
    # local z to the surface normal: road z, facade y (a quarter turn
    # about x), far wall x (a quarter turn about y); a yaw about it
    h = math.sqrt(0.5)
    q_road = torch.tensor([1.0, 0.0, 0.0, 0.0], device=dev)
    q_fac = torch.tensor([h, h, 0.0, 0.0], device=dev)
    q_far = torch.tensor([h, 0.0, h, 0.0], device=dev)
    q0 = torch.where((surface == 0)[:, None], q_road, torch.where((surface == 1)[:, None], q_fac, q_far))
    ang = math.pi * _rand(g, n)
    q_spin = torch.stack([torch.cos(ang / 2), 0 * ang, 0 * ang, torch.sin(ang / 2)], -1)
    rot = _quat_mul(q0, q_spin) + 0.04 * _randn(g, n, 4)
    return xyz, rgb.clamp(0.0, 1.0), torch.log(scale), rot


def _actor_points(cfg: dict, g: torch.Generator, n: int, half: torch.Tensor, color: torch.Tensor):
    """n Gaussians on the surface of a car's box (canonical frame, x
    forward): (xyz, rgb, log_scale, rot)."""
    dev = g.device
    u = _rand(g, n, 3) * 2 - 1
    face = torch.randint(0, 3, (n,), generator=g, device=dev)
    sign = torch.where(_rand(g, n) < 0.5, -1.0, 1.0)
    xyz = u * half
    xyz = torch.where(torch.nn.functional.one_hot(face, 3).bool(), sign[:, None] * half, xyz)
    shade = 0.75 + 0.25 * (xyz[:, 2:3] / half[2]).clamp(-1, 1)
    rgb = color[None, :] * shade + 0.04 * _randn(g, n, 3)
    scale = cfg["actor_gaussian_scale_m"] * torch.exp(0.3 * _randn(g, n, 3))
    rot = torch.tensor([1.0, 0.0, 0.0, 0.0], device=dev) + 0.3 * _randn(g, n, 4)
    return xyz, rgb.clamp(0.0, 1.0), torch.log(scale), rot


def make_scene(cfg: dict, seed: int, device, iteration: Optional[int] = None) -> StreetScene:
    """The configuration's street scene at its snapshot iteration (or
    `iteration`: Adam's step counts), from `seed`, on `device`."""
    dev = torch.device(device)
    g = make_generator(seed, dev, stream=0)
    W, H, K, views, train = make_views(cfg)
    first, last = cfg["frames"]
    F = last - first + 1
    sh_k = (cfg["sh_degree"] + 1) ** 2
    fdim = cfg["fourier_dim"]
    A = cfg["actors"]
    rows = cfg["rows"]

    # layout: the background, then one slice an actor
    names = ["background"] + [f"obj_{a:03d}" for a in range(A)]
    caps = [rows["background_capacity"]] + [rows["actor_capacity"]] * A
    alive_n = [rows["background_alive"]] + [rows["actor_alive"]] * A
    starts = np.cumsum([0] + caps[:-1])
    slices = np.stack([starts, starts + np.array(caps)], 1).astype(np.int64)
    C = int(slices[-1, 1])

    xyz = torch.zeros((C, 3), device=dev)
    rgb = torch.zeros((C, 3), device=dev)
    log_scale = torch.full((C, 3), -10.0, device=dev)
    rot = torch.zeros((C, 4), device=dev)
    rot[:, 0] = 1.0
    alive = torch.zeros(C, dtype=torch.bool, device=dev)
    model_id = torch.zeros(C, dtype=torch.int64, device=dev)

    def place(m: int, pts):
        s, e = (int(v) for v in slices[m])
        n = pts[0].shape[0]
        # the live rows of a slice mid-training sit between pruned ones
        slot = s + torch.randperm(e - s, generator=g, device=dev)[:n]
        model_id[s:e] = m
        for dst, src in zip((xyz, rgb, log_scale, rot), pts):
            dst[slot] = src
        alive[slot] = True

    place(0, _background(cfg, g, alive_n[0]))

    # actors: boxes driving in the lanes, some entering and leaving
    half = torch.tensor(cfg["actor_half_size"], device=dev)
    colors = 0.15 + 0.8 * _rand(g, A, 3)
    lane_y = torch.tensor([(-1.75 if a % 2 == 0 else 1.75) * (1 + (a // 2) % 2) for a in range(A)], device=dev)
    speed = torch.where(lane_y < 0, 1.0, -1.0) * (0.6 + 0.8 * _rand(g, A))
    x_start = cfg["street_start"] + 10.0 + (cfg["street_extent"][1] - cfg["street_start"] - 20.0) * _rand(g, A)
    fi = torch.arange(F, device=dev, dtype=torch.float32)
    world = torch.stack([x_start[None, :] + speed[None, :] * fi[:, None],
                         lane_y[None, :].expand(F, A), half[2].expand(F, A)], -1)  # [F, A, 3]
    yaw = torch.where(speed < 0, math.pi, 0.0)[None, :].expand(F, A).clone()
    yaw = yaw + 0.02 * torch.sin(0.1 * fi[:, None] + torch.arange(A, device=dev)[None, :])
    life = cfg["actor_lifetimes"]
    start_frame = [0] + [first + int(life[a % len(life)][0] * (F - 1)) for a in range(A)]
    end_frame = [1 << 30] + [first + int(life[a % len(life)][1] * (F - 1)) for a in range(A)]
    for a in range(A):
        place(1 + a, _actor_points(cfg, g, alive_n[1 + a], half, colors[a]))

    # tracklets in the ego frame: trans = R_ego^T (world - ego), quat =
    # q_ego^-1 q_world
    ego = np.stack([views[i * len(cfg["cameras"])].ego_pose for i in range(F)])  # [F, 4, 4]
    Rego = torch.tensor(ego[:, :3, :3], dtype=torch.float32, device=dev)
    tego = torch.tensor(ego[:, :3, 3], dtype=torch.float32, device=dev)
    track_trans = torch.einsum("fji,faj->fai", Rego, world - tego[:, None, :])
    ego_yaw = torch.tensor(np.arctan2(ego[:, 1, 0], ego[:, 0, 0]), dtype=torch.float32, device=dev)
    rel = yaw - ego_yaw[:, None]
    track_rots = torch.stack([torch.cos(rel / 2), 0 * rel, 0 * rel, torch.sin(rel / 2)], -1)
    opt_trans = 0.02 * _randn(g, F, A, 3)
    opt_rots = 0.005 * _randn(g, F, A, 1)

    # Gaussian colours as SH, the actors' Fourier terms, view-dependent
    # terms mid-training
    feat_dc = torch.zeros((C, fdim, 3), device=dev)
    feat_dc[:, 0] = (rgb - 0.5) / SH_C0
    is_actor = model_id > 0
    if fdim > 1:
        feat_dc[:, 1:] = torch.where(is_actor[:, None, None], 0.05 * _randn(g, C, fdim - 1, 3), 0.0)
    feat_rest = 0.03 * _randn(g, C, sh_k - 1, 3)
    op = cfg["opacity_logit_mean"] + cfg["opacity_logit_std"] * _randn(g, C, 1)
    # a share of the rows fell below min_opacity since the last round
    op = torch.where(_rand(g, C, 1) < cfg["faint_share"], torch.full_like(op, -6.0), op)
    dead = ~alive
    feat_dc[dead] = 0.0
    feat_rest[dead] = 0.0
    op[dead] = -10.0

    # the sky cubemap, trained toward the sky: texel directions per
    # face (the nvdiffrast layout) coloured by sky_color, with noise
    sky_cubemap = torch.zeros((3, 0), device=dev)
    if cfg["include_sky"]:
        R = cfg["sky_resolution"]
        ii = (torch.arange(R, device=dev, dtype=torch.float32) + 0.5) / R * 2 - 1
        v, u = torch.meshgrid(ii, ii, indexing="ij")
        one = torch.ones_like(u)
        dirs = torch.stack([torch.stack([one, -v, -u], -1), torch.stack([-one, -v, u], -1),
                            torch.stack([u, one, v], -1), torch.stack([u, -one, -v], -1),
                            torch.stack([u, -v, one], -1), torch.stack([-u, -v, -one], -1)])  # [6, R, R, 3]
        d = dirs.reshape(-1, 3)
        d = d / d.norm(dim=-1, keepdim=True)
        # the program looks the cubemap up by world directions (z up)
        sky = sky_color(d) + 0.02 * _randn(g, d.shape[0], 3)
        # inside (0, 1): the lookup's clamp at 0 and 1 has no tie to break
        sky_cubemap = sky.clamp(0.02, 0.98).t().contiguous()

    # Adam's second moments at the snapshot: each leaf at its own scale
    nu_scale = cfg["adam_nu_scale"]
    leaves = {"gaussians.xyz": xyz, "gaussians.feat_dc": feat_dc, "gaussians.feat_rest": feat_rest,
              "gaussians.log_scale": log_scale, "gaussians.rot": rot, "gaussians.opacity_logit": op,
              "gaussians.semantic": torch.zeros((C, 1), device=dev),
              "actor_pose.opt_trans": opt_trans, "actor_pose.opt_rots": opt_rots}
    if cfg["include_sky"]:
        leaves["sky.cubemap"] = sky_cubemap
    adam_nu = {}
    for k, t in leaves.items():
        s = nu_scale.get(k, 0.0)
        nu = (s * _randn(g, *t.shape)) ** 2
        if k.startswith("gaussians."):
            nu = torch.where(alive.reshape((C,) + (1,) * (t.dim() - 1)), nu, 0.0)
        adam_nu[k] = nu

    models = Models(
        names=names, slices=slices,
        start_frame=np.array(start_frame), end_frame=np.array(end_frame),
        extent=np.array([cfg["scene_radius"]] + [float(max(cfg["actor_half_size"]) * 1.5)] * A),
        track_id=np.array([-1] + list(range(A))),
        box_half=np.array([[0.0, 0.0, 0.0]] + [cfg["actor_half_size"]] * A),
        flip_prob=np.array([0.0] + [cfg["flip_prob"]] * A),
    )
    return StreetScene(
        cfg=cfg, H=H, W=W, K=K, views=views, train_views=train, models=models, capacity=C,
        xyz=xyz, feat_dc=feat_dc, feat_rest=feat_rest, log_scale=log_scale, rot=rot,
        opacity_logit=op, semantic=torch.zeros((C, 1), device=dev), alive=alive, model_id=model_id,
        track_trans=track_trans, track_rots=track_rots, opt_trans=opt_trans, opt_rots=opt_rots,
        actor_world=world, actor_yaw=yaw, actor_colors=colors, sky_cubemap=sky_cubemap,
        adam_nu=adam_nu, adam_count=cfg["snapshot_iteration"] if iteration is None else int(iteration),
        scene_radius=float(cfg["scene_radius"]),
        sphere_center=np.array(cfg["sphere_center"], np.float64), sphere_radius=float(cfg["sphere_radius"]),
    )


# ---- ground truth ----


@dataclasses.dataclass
class Truth:
    """One view's supervision, [H, W, ...] on the device."""

    image: torch.Tensor  # [H, W, 3] float32
    sky_mask: torch.Tensor  # [H, W, 1] bool
    lidar_depth: torch.Tensor  # [H, W] float32, 0 where no return
    obj_bound: torch.Tensor  # [H, W, 1] bool


def view_rays(scene: StreetScene, view: View, device):
    """World-space ray origin [3] and unit directions [H W, 3] through
    the pixel centres (float64 on the host's numbers, float32 out)."""
    dev = torch.device(device)
    c2w = np.linalg.inv(view.w2c)
    ys, xs = torch.meshgrid(torch.arange(scene.H, device=dev, dtype=torch.float64) + 0.5,
                            torch.arange(scene.W, device=dev, dtype=torch.float64) + 0.5, indexing="ij")
    K = scene.K
    d_cam = torch.stack([(xs - K[0, 2]) / K[0, 0], (ys - K[1, 2]) / K[1, 1], torch.ones_like(xs)], -1).reshape(-1, 3)
    d = d_cam @ torch.tensor(c2w[:3, :3].T, device=dev)
    d = d / d.norm(dim=-1, keepdim=True)
    return torch.tensor(c2w[:3, 3], device=dev), d


def make_truth(scene: StreetScene, view: View, device) -> Truth:
    """Cast the view's rays against the street, the far wall and the
    actors' boxes; colour the nearest hit; LiDAR returns on a sparse
    pixel lattice up to `lidar_range` metres."""
    cfg = scene.cfg
    dev = torch.device(device)
    o, d = view_rays(scene, view, dev)
    n = d.shape[0]
    inf = torch.full((n,), float("inf"), device=dev, dtype=torch.float64)
    best, surf = inf.clone(), torch.full((n,), -1, device=dev)
    x0, x1 = cfg["street_extent"]
    # road plane z = 0
    t = torch.where(d[:, 2] < -1e-9, -o[2] / d[:, 2], inf)
    p = o + t[:, None] * d
    ok = (t > 0) & (p[:, 0] >= x0) & (p[:, 0] <= x1 + 8.0) & (p[:, 1].abs() <= cfg["facade_offset"])
    best = torch.where(ok, t, best)
    surf = torch.where(ok, 0, surf)
    # facades y = +-offset
    for side in (-1.0, 1.0):
        t = (side * cfg["facade_offset"] - o[1]) / torch.where(d[:, 1].abs() > 1e-12, d[:, 1], 1e-12)
        p = o + t[:, None] * d
        hgt = building_height(cfg, p[:, 0].float(), torch.full_like(p[:, 0], side).float()).double()
        ok = (t > 0) & (t < best) & (p[:, 0] >= x0) & (p[:, 0] <= x1) & (p[:, 2] >= 0) & (p[:, 2] <= hgt)
        best = torch.where(ok, t, best)
        surf = torch.where(ok, 1, surf)
    # far wall x = end + 8
    t = (x1 + 8.0 - o[0]) / torch.where(d[:, 0].abs() > 1e-12, d[:, 0], 1e-12)
    p = o + t[:, None] * d
    ok = (t > 0) & (t < best) & (p[:, 1].abs() <= 3 * cfg["facade_offset"]) & (p[:, 2] >= 0) & (p[:, 2] <= cfg["far_height"])
    best = torch.where(ok, t, best)
    surf = torch.where(ok, 2, surf)
    hit = torch.isfinite(best)
    p = o + torch.where(hit, best, 0.0)[:, None] * d
    color = street_color(cfg, p.float(), surf.clamp(min=0).float())
    # actors alive at this frame: slab test in each box's frame
    obj = torch.zeros(n, dtype=torch.bool, device=dev)
    m = scene.models
    for a in range(scene.cfg["actors"]):
        if not (m.start_frame[1 + a] <= view.frame <= m.end_frame[1 + a]):
            continue
        c = scene.actor_world[view.frame_idx, a].double()
        yw = float(scene.actor_yaw[view.frame_idx, a])
        Rb = torch.tensor(yaw_rotmat(yw), device=dev)
        ol = (o - c) @ Rb
        dl = d @ Rb
        half = torch.tensor(m.box_half[1 + a], device=dev)
        inv = 1.0 / torch.where(dl.abs() > 1e-12, dl, 1e-12)
        ta, tb = (-half - ol) * inv, (half - ol) * inv
        tn = torch.minimum(ta, tb).max(dim=1).values
        tf = torch.maximum(ta, tb).min(dim=1).values
        box = (tn <= tf) & (tf > 0)
        obj |= box
        near = box & (tn > 0) & (tn < best)
        pl = ol + tn[:, None] * dl
        shade = 0.75 + 0.25 * (pl[:, 2] / half[2]).clamp(-1, 1)
        color = torch.where(near[:, None], (scene.actor_colors[a].double()[None, :] * shade[:, None]).float(), color)
        best = torch.where(near, tn, best)
        hit = hit | near
    sky = sky_color(d.float()) if cfg.get("sky_in_truth", "sky") == "sky" else torch.ones_like(color)
    rgb = torch.where(hit[:, None], color, sky)
    # LiDAR: camera-space z of the hit on every `lidar_stride`-th row and column
    z_cam = (best * (d @ torch.tensor(view.w2c[:3, :3].T, device=dev))[:, 2]).float()
    s = cfg["lidar_stride"]
    yy, xx = torch.meshgrid(torch.arange(scene.H, device=dev), torch.arange(scene.W, device=dev), indexing="ij")
    lattice = ((yy % s == 0) & (xx % s == 0)).reshape(-1)
    lidar = torch.where(lattice & hit & (best < cfg["lidar_range"]), z_cam, 0.0)
    H, W = scene.H, scene.W
    return Truth(image=rgb.reshape(H, W, 3).contiguous(), sky_mask=(~hit).reshape(H, W, 1),
                 lidar_depth=lidar.reshape(H, W).contiguous(), obj_bound=obj.reshape(H, W, 1))
