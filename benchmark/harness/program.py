"""The system under test, built from the benchmark's scene.

The only module of the harness that imports the program
(`street_gaussians_torch`). It hands the program the generated scene
through its public constructors and dataclasses (the config reader's
defaults, `SceneTable`, `GaussianParams`, `GaussianAux`, the actor pose
store, the sky, `utils.camera.make_camera`, `train_lib.init_train_state`)
and returns the entry points that the window drives:
`train_lib.make_train_step`'s step with `train_lib.densify_cadence`, as
`runner.training` calls them each iteration, and
`runner.make_eval_render`'s render.
"""

from __future__ import annotations

import copy
import dataclasses
import math
from typing import Dict, List

import numpy as np
import torch

from benchmark.harness.scene import StreetScene, Truth


def merge(dst, src: dict):
    """dst with the nested dict src written over it."""
    for k, v in src.items():
        if isinstance(v, dict):
            merge(dst[k], v)
        else:
            dst[k] = v
    return dst


@dataclasses.dataclass
class Program:
    cfg: object  # the program's Config
    table: object
    pose_data: object
    state: object  # train_lib.TrainState at the snapshot
    frames: List[object]  # FrameInput per view
    truths: Dict[int, object]  # GroundTruth per view index
    opts_train: object


def load_recipe(recipe: dict):
    from street_gaussians_torch.config import default_config

    return merge(default_config(), copy.deepcopy(recipe))


def build(scene: StreetScene, recipe: dict, truths: Dict[int, Truth], device) -> Program:
    from street_gaussians_torch.models import gaussians as G
    from street_gaussians_torch.models.actor_pose import ActorInterp, ActorPoseData, ActorPoseParams
    from street_gaussians_torch.models.renderer import FrameInput, SceneParams
    from street_gaussians_torch.models.sky_cubemap import SkyParams
    from street_gaussians_torch.optim.adam import AdamState
    from street_gaussians_torch.runner import render_opts_from_cfg
    from street_gaussians_torch.train_lib import GroundTruth, init_train_state
    from street_gaussians_torch.utils.camera import make_camera

    dev = torch.device(device)
    cfg = load_recipe(recipe)
    m = scene.models
    M = len(m.names)
    t = lambda a, dt: torch.as_tensor(np.asarray(a), dtype=dt, device=dev)  # noqa: E731
    sc = scene.cfg
    table = G.SceneTable(
        names=list(m.names), slices=m.slices.copy(), capacity=scene.capacity,
        track_id=t(m.track_id, torch.int32), class_label=t(np.zeros(M), torch.int32),
        deformable=t(np.zeros(M, bool), torch.bool), random_init=t(np.zeros(M, bool), torch.bool),
        start_frame=t(m.start_frame, torch.int32), end_frame=t(m.end_frame, torch.int32),
        extent=t(m.extent, torch.float32), spatial_lr_scale=t(m.extent, torch.float32),
        flip_prob=t(m.flip_prob, torch.float32), bbox_half=t(m.box_half, torch.float32),
        fourier_scale=float(sc["fourier_scale"]),
        scene_center=np.zeros(3, np.float32), scene_radius=scene.scene_radius,
        sphere_center=scene.sphere_center.astype(np.float32), sphere_radius=scene.sphere_radius,
        sh_degree_bkgd=sc["sh_degree"], sh_degree_obj=sc["sh_degree"], fourier_dim=sc["fourier_dim"],
        num_classes=20, use_semantic=False, sky_model=-1,
    )
    c = lambda x: x.clone()  # noqa: E731
    gp = G.GaussianParams(xyz=c(scene.xyz), feat_dc=c(scene.feat_dc), feat_rest=c(scene.feat_rest),
                          log_scale=c(scene.log_scale), rot=c(scene.rot), opacity_logit=c(scene.opacity_logit),
                          semantic=c(scene.semantic))
    C = scene.capacity
    aux = G.GaussianAux(alive=c(scene.alive), model_id=c(scene.model_id), grad_accum=torch.zeros((C, 2), device=dev),
                        denom=torch.zeros(C, device=dev), max_radii=torch.zeros(C, device=dev))
    pose_data = ActorPoseData(input_trans=c(scene.track_trans), input_rots=c(scene.track_rots))
    params = SceneParams(
        gaussians=gp, actor_pose=ActorPoseParams(opt_trans=c(scene.opt_trans), opt_rots=c(scene.opt_rots)),
        sky=SkyParams(cubemap=c(scene.sky_cubemap)) if sc["include_sky"] else None,
        color_correction=None, pose_correction=None,
    )
    state = init_train_state(params, aux)
    # Adam mid-training: zero first moments, the scene's second moments,
    # step counts at the snapshot on the live rows
    nu = {k: c(scene.adam_nu[k]) for k in state.adam.nu}
    count = {k: (scene.alive.to(v.dtype) * scene.adam_count if v.dim() else torch.full_like(v, scene.adam_count))
             for k, v in state.adam.count.items()}
    state = dataclasses.replace(state, adam=AdamState(mu=state.adam.mu, nu=nu, count=count),
                                step=scene.adam_count)

    A = sc["actors"]
    frames = []
    for v in scene.views:
        cam = make_camera(scene.K, v.w2c, scene.H, scene.W, frame=v.frame, timestamp=v.frame_idx / 100.0,
                          cam_id=v.cam, image_id=v.image_id, device=dev)
        yaw = math.atan2(v.ego_pose[1, 0], v.ego_pose[0, 0])
        interp = ActorInterp(frame_idx=torch.full((A, 4), v.frame_idx, dtype=torch.int64, device=dev),
                             col_idx=torch.arange(A, device=dev)[:, None].expand(A, 4).contiguous(),
                             ratios=torch.zeros((A, 3), device=dev))
        frames.append(FrameInput(
            cam=cam, ego_quat=t([math.cos(yaw / 2), 0.0, 0.0, math.sin(yaw / 2)], torch.float32),
            ego_rotmat=t(v.ego_pose[:3, :3], torch.float32), ego_trans=t(v.ego_pose[:3, 3], torch.float32),
            interp=interp))
    sky_scales = list(recipe.get("optim", {}).get("lambda_sky_scale", []))
    gts = {}
    for i, tr in truths.items():
        cam = scene.views[i].cam
        gts[i] = GroundTruth(
            image=tr.image, mask=torch.ones((scene.H, scene.W, 1), dtype=torch.bool, device=dev),
            sky_mask=tr.sky_mask, lidar_depth=tr.lidar_depth, obj_bound=tr.obj_bound,
            sky_scale=torch.tensor(float(sky_scales[cam]) if cam < len(sky_scales) else 1.0, device=dev))
    return Program(cfg=cfg, table=table, pose_data=pose_data, state=state, frames=frames, truths=gts,
                   opts_train=render_opts_from_cfg(cfg, "train"))


def clone_state(state):
    """A deep copy of a TrainState's tensors (the cycle's snapshot)."""
    return copy.deepcopy(state)


def train_fns(prog: Program, wrap=None):
    """(step_fn, densify_fn, reset_fn, cadence) as runner.training uses
    them: step_fn(state, frame, gt, draws=) and cadence(state, iteration,
    generator) -> (state, densify diagnostics or None). wrap: applied to
    the densify function (the traced run times it)."""
    from street_gaussians_torch import train_lib

    step_fn = train_lib.make_train_step(prog.cfg, prog.table, prog.pose_data, prog.opts_train)
    densify_fn = train_lib.make_densify_fn(prog.cfg, prog.table)
    if wrap is not None:
        densify_fn = wrap(densify_fn)
    reset_fn = train_lib.make_reset_opacity_fn()

    def cadence(state, iteration, generator):
        return train_lib.densify_cadence(prog.cfg, state, iteration, densify_fn, reset_fn, generator)

    return step_fn, densify_fn, reset_fn, cadence


def with_thresholds(prog: Program, factor: float) -> Program:
    """prog with every densify threshold of its configuration scaled by
    factor (a planted fault, tests and calibrate.py only)."""
    cfg = copy.deepcopy(prog.cfg)
    for k in ("densify_grad_threshold", "densify_grad_threshold_bkgd", "densify_grad_threshold_obj"):
        if cfg.optim.get(k) is not None:
            cfg.optim[k] = cfg.optim[k] * factor
    return dataclasses.replace(prog, cfg=cfg)


def densify_draws(capacity: int, g: torch.Generator):
    """A densify round's draws as the program takes them from its
    generator: the box test's [C, 2, 3] standard normals, then the two
    split samples' [C, 3]."""
    return tuple(torch.randn(shape, generator=g, device=g.device)
                 for shape in ((capacity, 2, 3), (capacity, 3), (capacity, 3)))


def make_draws(table_flip_prob_rows: torch.Tensor, H: int, W: int, with_sky: bool, g: torch.Generator):
    """A step's draws as the program draws them (flip first, then the
    sky jitter), from the benchmark's generator."""
    from street_gaussians_torch.train_lib import Draws

    flip = torch.rand(table_flip_prob_rows.shape[0], generator=g, device=g.device) < table_flip_prob_rows
    jitter = (torch.rand((H, W, 2), generator=g, device=g.device) - 0.5) if with_sky else None
    return Draws(flip, jitter)


def eval_render(prog: Program):
    """runner.make_eval_render's render and the sky table built once."""
    from street_gaussians_torch.data.dataset import Scene
    from street_gaussians_torch.models.sky_cubemap import build_sky_table
    from street_gaussians_torch.runner import make_eval_render

    scene = Scene(table=prog.table, params_init=prog.state.params.gaussians, aux_init=prog.state.aux,
                  pose_data=prog.pose_data, pose_params_init=prog.state.params.actor_pose,
                  train_views=[], test_views=[], metadata={})
    render = make_eval_render(prog.cfg, scene)
    sky_table = None
    if prog.state.params.sky is not None:
        with torch.no_grad():
            sky_table = build_sky_table(prog.state.params.sky.cubemap)
    return render, sky_table


def build_kernels() -> None:
    """Compile the main path's CUDA libraries (a no-op once built)."""
    from street_gaussians_torch.kernels import _build

    _build.build(("fill", "tile_blend", "tile_blend_bwd", "segsum"))
