"""Training, rendering and evaluation orchestration (the host-side loop).

Port of street_gaussians_tpu/runner.py on one device: `build_scene`,
`build_initial_params`, `render_opts_from_cfg`, the ground-truth cache
(`GTCache`, on the device), the single-device `make_eval_render`,
`evaluate_psnr`, `save_scene_artifacts`, `training` (the single-camera
path with the overflow watchdog, train_log.jsonl, test, save and
checkpoint iterations and the resume), `render_sets` (the demand-adaptive
capacity ladder, the per-view regrow, the sky table built once),
`render_trajectory` (full, object and background renders of every view
in frame order, per-channel PNGs and videos) and `evaluate_metrics`
(PSNR, SSIM and, where its weights are found, LPIPS over the saved
renders).

The parallel modes (parallel/dp.py, parallel/tiles.py, parallel/gauss.py):
`training` takes a camera batch (train.batch_size B) over a process
group of B ranks, one camera a rank; tile-row bands (train.tile_shards
D) in turn in one process or over a band group of D ranks; Gaussian row
blocks (train.gauss_shards G) in turn in one process or over a gauss
group of G ranks (the per-row state split G ways); and the JAX
runner's compositions: B ranks each with its camera in D bands, B x G
ranks (gauss x camera: a gauss group of G ranks a camera, inside one
host) and G ranks each rendering D bands in turn (gauss x tile).
train.multihost: each host (torchrun --nnodes) trains on its own slice
of every shuffled epoch (parallel/dp.node_views). Rank 0 alone writes
the logs, checkpoints, PLY and evals; a row-sharded state is gathered
on every rank before densify, the opacity reset, evals, saves and the
final checksum, and sharded again after densify and the reset.
`make_eval_render` and so `render_sets` serve in bands with
render.parallel "tile=N", in row blocks with "gauss=N" and in both with
"gausstile=GxT" (in turn in one process).

Every 1,000 iterations `training` writes the debug grid of
`log_image_grid` (gt | render | depth colour over acc | object render |
object acc) to model_path/log_images/<iteration>.png; the JAX package
writes the same grid as <iteration>.jpg through cv2, so the two differ in
file format only.

Not ported (raises NotImplementedError where a config asks for it): the
viewer bridge (ROADMAP.md queue 1, item 5).
"""

from __future__ import annotations

import contextlib
import copy
import functools
import json
import os
import random
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from street_gaussians_torch import checkpoint as ckpt_lib
from street_gaussians_torch._device import resolve_device
from street_gaussians_torch.config import Config, save_config
from street_gaussians_torch.data.dataset import CameraView, Scene, load_ground_truth, load_waymo_scene
from street_gaussians_torch.models.corrections import init_color_correction, init_pose_correction
from street_gaussians_torch.models.renderer import (
    RenderOptions,
    SceneParams,
    render_background_mask,
    render_frame,
    render_object_mask,
    screen_space,
)
from street_gaussians_torch.models.sky_cubemap import build_sky_table, init_sky
from street_gaussians_torch.train_lib import (
    GroundTruth,
    TrainState,
    densify_cadence,
    init_train_state,
    make_densify_fn,
    make_reset_opacity_fn,
    make_train_step,
)
from street_gaussians_torch.utils import losses as L
from street_gaussians_torch.utils.image_io import imread, imwrite
from street_gaussians_torch.utils.lpips import lpips as lpips_fn
from street_gaussians_torch.visualize import Visualizer, save_image, visualize_depth

EVAL_STEP = 10**9  # SH degree fully active


def _not_ported(what: str, item):
    raise NotImplementedError(f"{what} is not ported to street_gaussians_torch yet (ROADMAP.md queue 1, item {item})")


def build_scene(cfg: Config, device=None) -> Scene:
    """The scene of cfg.data.type (Waymo, Kitti, Colmap, Blender or
    SyntheticToy) on `device`."""
    device = resolve_device(device)
    dtype = cfg.data.type
    if dtype in ("Waymo", "Kitti"):
        return load_waymo_scene(cfg, device=device)
    if dtype == "Colmap":
        from street_gaussians_torch.data.static_readers import load_colmap_scene

        return load_colmap_scene(cfg, device=device)
    if dtype == "Blender":
        from street_gaussians_torch.data.static_readers import load_blender_scene

        return load_blender_scene(cfg, device=device)
    if dtype == "SyntheticToy":
        from street_gaussians_torch.data.synthetic import make_synthetic_scene

        syn = make_synthetic_scene(**cfg.data.get("synthetic_kwargs", {}), device=device)
        views = [
            CameraView(
                frame_input=f,
                image_path="",
                H=f.cam.H,
                W=f.cam.W,
                cam=0,
                frame=i,
                frame_idx=i,
                timestamp=float(syn.timestamps[i]),
                is_val=False,
                image_name=f"{i:06d}_0",
            )
            for i, f in enumerate(syn.frames)
        ]
        return Scene(
            table=syn.table,
            params_init=syn.params_init,
            aux_init=syn.aux,
            pose_data=syn.pose_data,
            pose_params_init=syn.pose_params_init,
            train_views=views,
            test_views=[],
            metadata=dict(num_images=len(views), num_cams=1, num_frames=len(views)),
        )
    raise NotImplementedError(f"dataset type {dtype}")


def build_initial_params(cfg: Config, scene: Scene, device=None) -> SceneParams:
    """The scene's initial Gaussians and actor poses, plus the sky and
    the corrections that cfg.model turns on, on `device`."""
    device = resolve_device(device)
    nsg = cfg.model.nsg
    sky = None
    if nsg.get("include_sky", False):
        sky = init_sky(cfg.model.sky.resolution, cfg.model.sky.get("white_background", True), device=device)
    cc = None
    if cfg.model.get("use_color_correction", False):
        num = (
            scene.metadata["num_images"]
            if cfg.model.color_correction.mode == "image"
            else scene.metadata["num_cams"]
        )
        cc = init_color_correction(num, device=device)
    pc = None
    if cfg.model.get("use_pose_correction", False):
        num = (
            scene.metadata["num_images"]
            if cfg.model.pose_correction.mode == "image"
            else scene.metadata["num_frames"]
        )
        pc = init_pose_correction(num, device=device)
    actor_pose = scene.pose_params_init if nsg.get("opt_track", True) else None
    return SceneParams(
        gaussians=scene.params_init,
        actor_pose=actor_pose,
        sky=sky,
        color_correction=cc,
        pose_correction=pc,
    )


def render_opts_from_cfg(cfg: Config, mode: str) -> RenderOptions:
    """RenderOptions from cfg.render and cfg.data; tile_capacity 0 or
    None means uncapped (= instance_capacity)."""
    ic = int(cfg.render.get("instance_capacity", 2**21))
    tc = int(cfg.render.get("tile_capacity", 0) or 0) or ic
    return RenderOptions(
        mode=mode,
        render_normal=cfg.render.get("render_normal", False),
        use_semantic=cfg.data.get("use_semantic", False),
        semantic_mode=cfg.model.gaussian.get("semantic_mode", "logits"),
        white_background=cfg.data.get("white_background", False),
        scaling_modifier=cfg.render.get("scaling_modifier", 1.0),
        tile_capacity=tc,
        instance_capacity=ic,
        sky_downsample=int(cfg.render.get("sky_downsample", 1) or 1),
        corner_cull=bool(cfg.render.get("corner_cull", True)),
    )


class GTCache:
    """Ground truth of the views on the device, keyed by view (as the JAX
    package keys it), the oldest evicted past max_items: the first epoch
    reads and resizes each view on the host, later epochs read nothing."""

    def __init__(self, white_background: bool = False, max_items: int = 1024, device=None):
        self.cache: Dict[int, GroundTruth] = {}
        self.white_background = white_background
        self.max_items = max_items
        self.device = resolve_device(device)
        self.misses = 0
        self.seconds = 0.0

    def get(self, view: CameraView) -> GroundTruth:
        key = id(view)
        if key not in self.cache:
            if len(self.cache) >= self.max_items:
                self.cache.pop(next(iter(self.cache)))
            t0 = time.perf_counter()
            self.cache[key] = load_ground_truth(view, self.white_background, device=self.device)
            self.seconds += time.perf_counter() - t0
            self.misses += 1
        return self.cache[key]

    @property
    def nbytes(self) -> int:
        return sum(getattr(gt, f).nbytes for gt in self.cache.values() for f in GroundTruth.__dataclass_fields__)


def make_eval_render(cfg: Config, scene: Scene, include_mask=None):
    """The eval render: eval_render(params, aux, frame, sky_table=None)
    -> render_frame's dict, at step 10^9 with cfg's eval options, no
    autograd. sky_table: build_sky_table(params.sky.cubemap) of frozen
    parameters (serving), else the table is built per call.
    render.parallel "tile=N" renders every view in N tile-row bands in
    turn (parallel/tiles.make_row_sharded_render: the whole frame's
    outputs, the overflow counters summed over the bands), "gauss=N"
    composes the table's rows in N blocks in turn and "gausstile=GxT"
    both (parallel/gauss.make_gauss_sharded_render: the whole frame's
    outputs, the integer ones equal to the single render's)."""
    opts = render_opts_from_cfg(cfg, "eval")
    if include_mask is not None:
        include_mask = torch.as_tensor(include_mask, device=scene.table.start_frame.device)
    par = str(cfg.render.get("parallel", "") or "")
    if par:
        kind, _, n = par.partition("=")
        if kind == "gausstile":
            from street_gaussians_torch.parallel.gauss import make_gauss_sharded_render

            dg, _, dt = n.partition("x")
            dg, dt = int(dg), int(dt or 2)
            inner = make_gauss_sharded_render(scene.table, scene.pose_data, opts, dg, tile_shards=dt,
                                              include_mask=include_mask)
            print(f"[render] gauss x tile sharded rendering: {dg} row blocks x {dt} tile bands, in turn")
            return torch.no_grad()(inner)
        if kind not in ("tile", "gauss"):
            raise ValueError(f"render.parallel={par!r}: unknown kind {kind!r} "
                             "(expected 'tile=N', 'gauss=N', or 'gausstile=GxT')")
        if int(n or 1) > 1:
            if kind == "tile":
                from street_gaussians_torch.parallel.tiles import make_row_sharded_render as make
            else:
                from street_gaussians_torch.parallel.gauss import make_gauss_sharded_render as make
            inner = make(scene.table, scene.pose_data, opts, int(n), include_mask=include_mask)
            print(f"[render] {kind}-sharded rendering in {int(n)} {'bands' if kind == 'tile' else 'row blocks'}, "
                  "in turn")
            return torch.no_grad()(inner)

    @torch.no_grad()
    def eval_render(params, aux, frame_inp, sky_table=None):
        return render_frame(params, aux, scene.table, scene.pose_data, frame_inp, EVAL_STEP, opts=opts,
                            include_mask=include_mask, sky_table=sky_table)

    return eval_render


def save_scene_artifacts(cfg: Config, scene: Scene) -> None:
    """input.ply + cameras.json for SIBR-style viewers
    (ref: lib/datasets/dataset.py:32-48, camera_utils.py:172-192)."""
    from street_gaussians_torch.utils import ply as ply_utils
    from street_gaussians_torch.utils.sh import sh_to_rgb

    host = lambda t: t.detach().cpu().numpy()  # noqa: E731
    s, e = scene.table.slices[scene.table.names.index("background")]
    alive = host(scene.aux_init.alive[s:e])
    pts = host(scene.params_init.xyz[s:e])[alive]
    cols = sh_to_rgb(host(scene.params_init.feat_dc[s:e, 0])[alive])
    ply_utils.write_points_ply(os.path.join(cfg.model_path, "input.ply"), pts, np.clip(cols, 0, 1))

    json_cams = []
    for i, view in enumerate(scene.test_views + scene.train_views):
        w2c = host(view.frame_input.cam.w2c)
        c2w = np.linalg.inv(w2c)
        K = host(view.frame_input.cam.K)
        json_cams.append({
            "id": i,
            "img_name": view.image_name,
            "width": view.W,
            "height": view.H,
            "position": c2w[:3, 3].tolist(),
            "rotation": [row.tolist() for row in c2w[:3, :3]],
            "fx": float(K[0, 0]),
            "fy": float(K[1, 1]),
        })
    with open(os.path.join(cfg.model_path, "cameras.json"), "w") as f:
        json.dump(json_cams, f)


def param_checksum(params: SceneParams) -> float:
    """Sum of |parameter| over every leaf, in float64 on the host (the
    JAX package's final `param_checksum`)."""
    from street_gaussians_torch.train_lib import flatten_params

    return float(sum(np.abs(v.detach().cpu().numpy().astype(np.float64)).sum()
                     for v in flatten_params(params).values()))


class _Plan:
    """How training runs: `batch` cameras a step (one a rank of
    `data_group`, or one a gauss group), each rendered in `tile_shards`
    bands (over `band_group` or in turn), the table's rows in
    `gauss_shards` blocks (over `gauss_group` or in turn); `nodes` hosts,
    each training on its own view slice (train.multihost). The checks
    and messages are the JAX runner's (runner.py:405-492)."""

    def __init__(self, cfg: Config, group=None):
        t = cfg.train
        if cfg.get("viewer", {}).get("enabled"):
            _not_ported("viewer.enabled (the SIBR viewer bridge)", 5)
        B = int(t.get("batch_size", 1) or 1)
        D = int(t.get("tile_shards", 0) or 0)
        Gs = int(t.get("gauss_shards", 0) or 0)
        ranks = group.size if group is not None else 1
        self.nodes = group.nodes if group is not None and t.get("multihost", False) else 1
        self.node = group.node if self.nodes > 1 else 0
        self.batch, self.tile_shards, self.gauss_shards = 1, max(D, 1), max(Gs, 1)
        self.data_group = self.band_group = self.gauss_group = None
        self.first_slice = None  # this host's views of the first epoch (train.multihost)
        if D > 1 and self.nodes > 1:
            raise NotImplementedError(
                "train.tile_shards across processes is not wired — tile bands exchange per-band images every "
                "step, which wants ICI; use camera-DP (train.multihost) across hosts and tile-sharding within "
                "one host")
        if Gs > 1:
            self._gauss(B, D, Gs, group, ranks)
        else:
            self._cameras_and_bands(B, D, group, ranks)
        if self.nodes > 1 and self.data_group is None and self.gauss_group is None:
            raise RuntimeError(
                f"train.multihost with {self.nodes} processes requires batch_size >= {self.nodes} (got {B}) so "
                "the data-parallel step ties the hosts together")
        self.group = group if (self.data_group or self.band_group or self.gauss_group) is not None else None
        if ranks > 1 and self.group is None:
            raise RuntimeError(f"a process group of {ranks} ranks needs train.batch_size {ranks} or "
                               f"train.tile_shards {ranks}")

    def _cameras_and_bands(self, B: int, D: int, group, ranks: int) -> None:
        if B > 1:
            if ranks > B:
                raise RuntimeError(f"train.batch_size={B} over {ranks} ranks: launch {B} ranks")
            if ranks == B:
                self.batch, self.data_group = B, group
                print(f"[dp] camera data parallel: {B} cameras a step, one a rank"
                      + (f", each in {D} tile bands in turn" if D > 1 else "")
                      + (f", over {self.nodes} hosts" if self.nodes > 1 else ""), flush=True)
            elif D > 1:
                raise RuntimeError(f"train.tile_shards={D} with batch_size={B} needs {B} ranks, have {ranks}")
            else:
                # the JAX runner trains one camera a step when it has
                # fewer devices than batch_size (runner.py:476-481)
                print(f"[dp] train.batch_size={B} needs {B} ranks, have {ranks}: training one camera a step",
                      flush=True)
        if D > 1 and self.data_group is None:
            if ranks == D:
                self.band_group = group
                print(f"[tile] tile-sharded training over {D} tile bands, one a rank", flush=True)
            elif ranks == 1:
                print(f"[tile] tile-sharded training in {D} tile bands, in turn", flush=True)
            else:
                raise RuntimeError(f"train.tile_shards={D} over {ranks} ranks: launch 1 or {D} ranks")

    def _gauss(self, B: int, D: int, Gs: int, group, ranks: int) -> None:
        """The gauss layouts: G ranks (or G blocks in turn in one
        process), B x G ranks (gauss x camera, the gauss groups inside a
        host), G ranks each rendering D bands in turn (gauss x tile)."""
        nodes = self.nodes
        if D > 1 and B > 1:
            raise NotImplementedError("3D data x gauss x tile training is not wired — drop batch_size or one "
                                      "shard axis")
        if B > 1:
            if nodes > 1 and B % nodes:
                raise RuntimeError(f"multi-host gauss x DP needs batch_size divisible by process_count "
                                   f"({B} % {nodes})")
            if ranks != B * Gs:
                raise RuntimeError(f"train.gauss_shards={Gs} x batch_size={B} needs {B * Gs} ranks, have {ranks}")
            self.batch = B
            self.gauss_group, self.data_group = group.split(Gs, data_per_node=B // nodes if nodes > 1 else None)
            print(f"[gauss] sharded training: {Gs} row shards x {B} cameras (2D: gauss groups of {Gs} ranks"
                  + (f", {nodes} hosts)" if nodes > 1 else ")"), flush=True)
            return
        if nodes > 1 and Gs % nodes:
            raise RuntimeError(f"multi-host gauss_shards={Gs} must be divisible by process_count={nodes} "
                               "(every process must hold row shards)")
        if ranks == Gs:
            self.gauss_group = group
        elif ranks != 1:
            raise RuntimeError(f"train.gauss_shards={Gs} needs {Gs} ranks (or one process: the row blocks in "
                               f"turn), have {ranks}")
        where = "one a rank" if self.gauss_group is not None else "in turn"
        print(f"[gauss] sharded training over {Gs} row shards, {where}"
              + (f", each rank rendering {D} tile bands in turn" if D > 1 else "")
              + (f", across {nodes} hosts" if nodes > 1 else ""), flush=True)

    def make_step(self, cfg: Config, scene: Scene):
        opts = render_opts_from_cfg(cfg, "train")
        if self.gauss_shards > 1:
            from street_gaussians_torch.parallel.gauss import make_gauss_sharded_train_step

            return make_gauss_sharded_train_step(cfg, scene.table, scene.pose_data, opts, self.gauss_shards,
                                                 group=self.gauss_group, data_group=self.data_group,
                                                 tile_shards=self.tile_shards)
        if self.data_group is not None:
            from street_gaussians_torch.parallel.dp import make_data_parallel_train_step

            return make_data_parallel_train_step(cfg, scene.table, scene.pose_data, opts, self.data_group,
                                                 tile_shards=self.tile_shards)
        if self.tile_shards > 1:
            from street_gaussians_torch.parallel.tiles import make_tile_sharded_train_step

            return make_tile_sharded_train_step(cfg, scene.table, scene.pose_data, opts, self.tile_shards,
                                                group=self.band_group)
        return make_train_step(cfg, scene.table, scene.pose_data, opts)

    def shards(self, scene: Scene):
        """The row blocks of this process (parallel/gauss.Shards); one
        block, the whole table, without gauss_shards. Checks the scene
        against the layout first."""
        from street_gaussians_torch.parallel.gauss import Shards

        if self.nodes > 1 and self.batch > 1 and self.gauss_shards == 1:
            hw = {(v.H, v.W) for v in scene.train_views}
            if len(hw) > 1:
                # hosts stack their batches apart: different resolutions
                # at one step would give the ranks different collectives
                raise RuntimeError(f"multi-host camera-DP requires a single camera resolution, got {sorted(hw)} "
                                   "— restrict data.cameras to one sensor size")
        C = scene.table.capacity
        if C % self.gauss_shards:
            raise RuntimeError(f"scene capacity {C} not divisible by gauss_shards={self.gauss_shards}")
        return Shards(C, self.gauss_shards, self.gauss_group)

    def view(self, view_stack: List[CameraView], scene: Scene, rng: random.Random) -> CameraView:
        """This rank's next view: refill the stack (shuffled; across hosts
        this host's slice) when it is empty, then pop this rank's camera
        of the batch."""
        from street_gaussians_torch.parallel.dp import node_views, pop_batch

        if not view_stack:
            view_stack.extend(scene.train_views)
            rng.shuffle(view_stack)
            if self.nodes > 1 and self.batch > 1:
                view_stack[:] = node_views(view_stack, self.node, self.nodes)
                if self.first_slice is None:
                    self.first_slice = [v.image_name for v in view_stack]
                    print(f"[multihost] host {self.node}/{self.nodes}: {len(view_stack)} views an epoch, "
                          f"first epoch {self.first_slice}", flush=True)
        if self.batch == 1:
            return view_stack.pop()
        local = self.batch // self.nodes
        return pop_batch(view_stack, local)[self.data_group.rank % local]


class _Watchdog:
    """The overflow watchdog (runner.py:739-761, :873-953): every 10
    iterations one sample of the step's instance and tile overflow; every
    10 samples, a kind that overflowed in at least 5 of them grows its
    capacity x2 (a tile capacity that reaches the instance capacity goes
    uncapped) while its grow budget lasts and the instance capacity stays
    within render.max_instance_capacity; past that, overflow_policy
    'error' raises and 'warn' trains on. Growth is written into
    cfg.render, as the JAX package does."""

    def __init__(self, cfg: Config):
        r = cfg.render
        self.cfg = cfg
        self.window: List[tuple] = []
        self.auto_grow = bool(r.get("auto_grow_capacity", True))
        budget = int(r.get("grow_budget", 3))
        self.budget = {"tile": budget, "instance": budget}
        self.ceiling = {"tile": None, "instance": int(r.get("max_instance_capacity", 2**23))}
        self.policy = str(r.get("overflow_policy", "error"))
        self.events: List[dict] = []

    def sample(self, iteration: int, ovf_i: float, ovf_t: float, log_f):
        """Returns True when a capacity grew (the caller rebuilds)."""
        self.window.append((ovf_i, ovf_t))
        if len(self.window) < 10:
            return False
        hits_i = sum(1 for a, _ in self.window if a > 0)
        hits_t = sum(1 for _, b in self.window if b > 0)
        self.window.clear()
        grew = False
        r = self.cfg.render
        for kind, hits, dropped in (("instance", hits_i, ovf_i), ("tile", hits_t, ovf_t)):
            if hits < 5:
                continue
            cap_key = f"{kind}_capacity"
            inst_cap = int(r.get("instance_capacity", 2**21))
            cap = int(r.get(cap_key, 0 if kind == "tile" else 2**21) or (inst_cap if kind == "tile" else 2**21))
            print(f"[overflow] {cap_key}={cap} exceeded in {hits}/10 recent samples (last drop: {dropped:.0f} "
                  "instances) — rendered pixels are missing occluded contributors", flush=True)
            new_cap = cap * 2
            if kind == "tile" and new_cap >= inst_cap:
                new_cap = 0  # grown past binding: go uncapped
            ceiling = self.ceiling[kind]
            if self.auto_grow and self.budget[kind] > 0 and (ceiling is None or cap * 2 <= ceiling):
                self.budget[kind] -= 1
                r[cap_key] = new_cap
                self.events.append({"iteration": iteration, "capacity": cap_key, "from": cap, "to": new_cap,
                                    "hits": hits})
                print(f"[overflow] growing {cap_key} -> {new_cap or 'uncapped'} (rebuilding the train step)",
                      flush=True)
                grew = True
            elif self.policy == "error":
                rec = {"iteration": iteration, "event": "capacity_overflow", "capacity": cap_key, "value": cap,
                       "dropped": dropped}
                log_f.write(json.dumps(rec) + "\n")
                log_f.flush()
                raise RuntimeError(
                    f"{cap_key}={cap} persistently exceeded at iteration {iteration} and growth is exhausted "
                    f"(auto_grow={self.auto_grow}, remaining budget={self.budget[kind]}, ceiling={ceiling}) — "
                    f"training would silently drop instances. Raise render.{cap_key}, render.grow_budget or "
                    f"render.max_instance_capacity, or set render.overflow_policy 'warn' to continue anyway. "
                    f"Last checkpoint in {self.cfg.trained_model_dir}")
        return grew


def training(cfg: Config, progress: bool = True, device=None, group=None) -> Dict:
    """Full training run (ref: train.py:24-225): one camera a step, or
    with `group` (a parallel.comm.Group, its ranks each running this
    function) the camera batch, band group or gauss group of
    train.batch_size, train.tile_shards and train.gauss_shards, and with
    train.multihost a view slice a host (see _Plan); the ranks' states
    stay bit-equal (a gauss group's hold their rows of one state), and
    rank 0 alone writes. Returns the final metrics (ema_psnr, ema_loss,
    num_alive, param_checksum) and, beside them, `timing` (seconds per
    stage, and ms/step over each 10-iteration window), the watchdog's
    `growth` events and the ground-truth cache's bytes."""
    device = group.device if group is not None else resolve_device(device)
    plan = _Plan(cfg, group)
    is_writer = group is None or group.rank == 0
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    t_begin = time.perf_counter()
    os.makedirs(cfg.model_path, exist_ok=True)
    if is_writer:
        save_config(cfg, os.path.join(cfg.model_path, "configs", "config_train.yaml"))
    scene = build_scene(cfg, device)
    if is_writer:
        try:
            save_scene_artifacts(cfg, scene)
        except Exception as exc:  # artifacts are viewer conveniences only
            print(f"[warn] scene artifacts not written: {exc}")
    shards = plan.shards(scene)
    params = build_initial_params(cfg, scene, device)
    state = init_train_state(params, scene.aux_init)
    if plan.group is not None:
        from street_gaussians_torch.parallel.dp import broadcast_state

        state = broadcast_state(state, plan.group)
    sync()
    timing = {"load_s": time.perf_counter() - t_begin, "resume_s": 0.0, "eval_s": 0.0, "save_s": 0.0,
              "log_images_s": 0.0}

    def build_train_step():
        return plan.make_step(cfg, scene)

    step_fn = build_train_step()
    densify_fn = make_densify_fn(cfg, scene.table)
    reset_fn = make_reset_opacity_fn()
    if shards.group is not None:
        # densify and the reset on the whole table, sharded again
        # (runner.py:826-851 re-places the rows)
        from street_gaussians_torch.parallel.gauss import whole_state

        densify_fn = functools.partial(whole_state, densify_fn, shards)
        reset_fn = functools.partial(whole_state, reset_fn, shards)
    eval_render = make_eval_render(cfg, scene)
    make_obj_render = lambda: (make_eval_render(cfg, scene, render_object_mask(scene.table))  # noqa: E731
                               if scene.table.num_models > 1 else None)
    eval_obj_render = make_obj_render()

    start_iter = 0
    if cfg.resume:
        t0 = time.perf_counter()
        restored, it = ckpt_lib.load_train_state(cfg.trained_model_dir, state)
        if restored is not None:
            state, start_iter = restored, it
            print(f"[resume] restored iteration {it}")
        timing["resume_s"] = time.perf_counter() - t0
    # the per-row leaves split over the gauss group (runner.py:671-674)
    state = shards.shard(state)

    o = cfg.optim
    iters = cfg.train.iterations
    gt_cache = GTCache(cfg.data.get("white_background", False), device=device)
    rng = random.Random(cfg.get("seed", 0))
    generator = torch.Generator(device=device).manual_seed(cfg.get("seed", 0))

    view_stack: List[CameraView] = []
    log_path = os.path.join(cfg.record_dir, "train_log.jsonl")
    os.makedirs(cfg.record_dir, exist_ok=True)
    log_f = open(log_path if is_writer else os.devnull, "a")

    # optional tensorboard (ref: train.py:227-260 prepare_output_and_logger)
    tb = None
    if is_writer:
        try:
            from torch.utils.tensorboard import SummaryWriter

            tb = SummaryWriter(cfg.model_path)
        except Exception:
            pass

    ema_loss, ema_psnr = 0.0, 0.0
    t_start = time.time()
    scalars, values = {}, {}
    watchdog = _Watchdog(cfg)
    # ms/step over each 10-iteration window, between the host syncs that
    # read the scalars; a window is marked with what else ran in it (a
    # ground-truth read, a densify round; an eval, save or growth just
    # before it)
    windows, t_window, marks = [], time.perf_counter(), set()
    try:
        for iteration in range(start_iter + 1, iters + 1):
            view = plan.view(view_stack, scene, rng)
            misses = gt_cache.misses
            gt = gt_cache.get(view)
            if gt_cache.misses != misses:
                marks.add("ground_truth")

            state, scalars = step_fn(state, view.frame_input, gt, generator)

            state, ddiag = densify_cadence(cfg, state, iteration, densify_fn, reset_fn, generator)
            if ddiag is not None:
                rec = {f"densify/{k}": int(v) for k, v in ddiag.items()}
                rec["iteration"] = iteration
                log_f.write(json.dumps(rec) + "\n")
                marks.add("densify")

            if iteration % 10 == 0:
                # one host sync for every scalar of the step
                values = dict(zip(scalars, torch.stack([v.double() for v in scalars.values()]).tolist()))
                loss, psnr_v = values["loss"], values["psnr"]
                if not np.isfinite(loss):
                    rec = {**values, "iteration": iteration, "event": "non_finite_loss"}
                    log_f.write(json.dumps(rec) + "\n")
                    log_f.flush()
                    raise RuntimeError(
                        f"non-finite loss {loss} at iteration {iteration} (scalars logged to {log_path}); "
                        f"last checkpoint in {cfg.trained_model_dir}")
                ema_loss = 0.4 * loss + 0.6 * ema_loss if ema_loss else loss
                ema_psnr = 0.4 * psnr_v + 0.6 * ema_psnr if ema_psnr else psnr_v
                now = time.perf_counter()
                windows.append({"iteration": iteration, "ms_per_step": (now - t_window) * 1e3 / 10,
                                "with": sorted(marks)})
                t_window, marks = now, set()
                if watchdog.sample(iteration, values.get("overflow_instance", 0.0),
                                   values.get("overflow_tile", 0.0), log_f):
                    step_fn = build_train_step()
                    eval_render = make_eval_render(cfg, scene)
                    eval_obj_render = make_obj_render()
                    marks.add("growth")
            if progress and is_writer and iteration % 100 == 0:
                dt = time.time() - t_start
                print(f"iter {iteration}/{iters} loss {ema_loss:.5f} psnr {ema_psnr:.2f} "
                      f"alive {int(values['num_alive'])} {(iteration - start_iter) / max(dt, 1e-9):.2f} it/s",
                      flush=True)
            if iteration % 10 == 0:
                rec = {**values, "iteration": iteration}
                log_f.write(json.dumps(rec) + "\n")
                log_f.flush()
                if tb is not None:
                    for k, v in values.items():
                        tb.add_scalar(f"train/{k}", v, iteration)

            if iteration % 1000 == 0:
                # the debug grid: the gather is a collective over the
                # gauss group and every rank renders (runner.py:971-1003);
                # the writer alone saves it
                t0 = time.perf_counter()
                state_full = shards.gather(state)
                r = eval_render(state_full.params, state_full.aux, view.frame_input)
                ro = (eval_obj_render(state_full.params, state_full.aux, view.frame_input)
                      if eval_obj_render is not None else None)
                if is_writer:
                    os.makedirs(os.path.join(cfg.model_path, "log_images"), exist_ok=True)
                    save_image(os.path.join(cfg.model_path, "log_images", f"{iteration}.png"),
                               log_image_grid(gt.image, r, ro))
                r = ro = state_full = None
                timing["log_images_s"] += time.perf_counter() - t0
                marks.add("log_images")

            saves = iteration in cfg.train.save_iterations or iteration in cfg.train.checkpoint_iterations
            if iteration in cfg.train.test_iterations or saves:
                # a collective over the gauss group: every rank, before
                # the writer's gates (runner.py:1017-1022)
                state_full = shards.gather(state)
            if iteration in cfg.train.test_iterations and is_writer:
                t0 = time.perf_counter()
                report = evaluate_psnr(cfg, scene, state_full, eval_render, gt_cache=gt_cache)
                timing["eval_s"] += time.perf_counter() - t0
                print(f"[eval @{iteration}] {report}", flush=True)
                log_f.write(json.dumps({"iteration": iteration, **report}) + "\n")
                log_f.flush()
                marks.add("eval")

            if is_writer and saves:
                t0 = time.perf_counter()
                if iteration in cfg.train.save_iterations:
                    ckpt_lib.save_point_cloud(cfg.point_cloud_dir, iteration, state_full.params.gaussians,
                                              state_full.aux, scene.table)
                if iteration in cfg.train.checkpoint_iterations:
                    ckpt_lib.save_train_state(cfg.trained_model_dir, iteration, state_full)
                timing["save_s"] += time.perf_counter() - t0
                marks.add("save")
            state_full = None
    finally:
        log_f.close()
        if tb is not None:
            tb.close()
    sync()
    final = {"ema_psnr": ema_psnr, "ema_loss": ema_loss}
    if scalars:
        final["num_alive"] = int(scalars["num_alive"])
    final["param_checksum"] = param_checksum(shards.gather(state).params)
    if plan.first_slice is not None:
        final["host_views"] = {"host": plan.node, "hosts": plan.nodes, "first_epoch": plan.first_slice}
    timing.update(ground_truth_s=gt_cache.seconds, total_s=time.perf_counter() - t_begin,
                  windows=windows)
    final.update(timing=timing, growth=watchdog.events, gt_cache_bytes=gt_cache.nbytes,
                 gt_cache_views=len(gt_cache.cache), start_iteration=start_iter, iterations=iters)
    return final


def log_image_grid(gt_image, render: Dict, obj_render: Optional[Dict] = None) -> np.ndarray:
    """The training log's debug grid (ref: train.py:146-163; the JAX
    runner's log_images): row 0 gt | render | depth colour, row 1 acc |
    object render | object acc (zeros without actors), [2H, 3W, 3]
    float in [0, 1]."""
    host = lambda t: t.detach().cpu().numpy()  # noqa: E731
    rgb = host(render["rgb"])
    depth_c, _ = visualize_depth(host(render["depth"]))
    acc = host(render["acc"])[..., None].repeat(3, -1)
    if obj_render is not None:
        obj_rgb = host(obj_render["rgb"])
        obj_acc = host(obj_render["acc"])[..., None].repeat(3, -1)
    else:
        obj_rgb = np.zeros_like(rgb)
        obj_acc = np.zeros_like(rgb)
    row0 = np.concatenate([host(gt_image), rgb, depth_c / 255.0], axis=1)
    row1 = np.concatenate([acc, obj_rgb, obj_acc], axis=1)
    return np.clip(np.concatenate([row0, row1], axis=0), 0, 1)


def evaluate_psnr(cfg: Config, scene: Scene, state: TrainState, eval_render, max_views=None,
                  gt_cache: Optional[GTCache] = None) -> Dict:
    """In-training eval on all held-out views and the first 5 train
    views (ref: train.py:274-303); `train.eval_max_views` caps each
    split. gt_cache: the training loop's cache (the views it holds are
    read once)."""
    out = {}
    if max_views is None:
        max_views = cfg.train.get("eval_max_views", None)
    if gt_cache is None:
        gt_cache = GTCache(cfg.data.get("white_background", False), device=state.aux.alive.device)
    for split, views in (("test", scene.test_views), ("train", scene.train_views[:5])):
        if not views:
            continue
        psnrs, l1s = [], []
        for view in views if max_views is None else views[:max_views]:
            gt = gt_cache.get(view)
            r = eval_render(state.params, state.aux, view.frame_input)
            psnrs.append(L.psnr(r["rgb"], gt.image, gt.mask))
            l1s.append(L.l1_loss(r["rgb"], gt.image, gt.mask))
        psnrs, l1s = torch.stack(psnrs).tolist(), torch.stack(l1s).tolist()
        out[f"{split}_psnr"] = sum(psnrs) / len(psnrs)
        out[f"{split}_l1"] = sum(l1s) / len(l1s)
    return out


def build_trained_scene(cfg: Config, device=None) -> Scene:
    """The scene as training built it (cfg.mode "train": the point
    clouds loaded), whatever cfg.mode says, so that its table fits the
    checkpoint's rows. The JAX package's render_sets builds it in
    evaluate mode, without the clouds: a smaller background slice than
    the checkpoint's rows (ROADMAP.md section 3). cfg is not written."""
    c = copy.deepcopy(cfg)
    c.mode = "train"
    return build_scene(c, device)


def load_trained_state(cfg: Config, scene: Scene, device) -> TrainState:
    """The newest checkpoint under cfg.trained_model_dir; raises
    FileNotFoundError when there is none."""
    params = build_initial_params(cfg, scene, device)
    state = init_train_state(params, scene.aux_init)
    restored, it = ckpt_lib.load_train_state(cfg.trained_model_dir, state)
    if restored is None:
        raise FileNotFoundError(f"no checkpoint under {cfg.trained_model_dir}")
    print(f"[render] loaded iteration {it}")
    return restored


def capacity_ladder(maxcap: int) -> List[int]:
    """The serving capacities: 1024, then x1.5 rounded up to a multiple
    of 128, up to max_instance_capacity."""
    ladder, c = [], 1024
    while c < maxcap:
        ladder.append(c)
        c = (int(c * 1.5) + 127) // 128 * 128
    ladder.append(maxcap)
    return ladder


def _serve_prune(cfg: Config, scene: Scene, state: TrainState) -> TrainState:
    """render.serve_prune_opacity: clear the alive bit of Gaussians with
    opacity below it; 'auto' keeps the largest candidate whose renders of
    3 probe views stay within render.serve_prune_tol of the exact ones."""
    import dataclasses

    sp = cfg.render.get("serve_prune_opacity", 0) or 0
    if not sp:
        return state
    op = torch.sigmoid(state.params.gaussians.opacity_logit[:, 0])
    alive0 = state.aux.alive

    def pruned_state(th):
        return dataclasses.replace(state, aux=dataclasses.replace(state.aux, alive=alive0 & (op >= th)))

    if str(sp) == "auto":
        tol = float(cfg.render.get("serve_prune_tol", 1.0 / 255.0))
        probe_r = make_eval_render(cfg, scene)
        pviews = (scene.test_views + scene.train_views)[:3]
        exact = [probe_r(state.params, state.aux, v.frame_input)["rgb"] for v in pviews]
        chosen = 0.0
        for th in (1 / 255, 2 / 255, 3 / 255, 5 / 255, 8 / 255):
            st = pruned_state(th)
            err = max(float((probe_r(st.params, st.aux, v.frame_input)["rgb"] - exact[i]).abs().max())
                      for i, v in enumerate(pviews))
            if err <= tol:
                chosen = th
            else:
                break
        sp = chosen
        print(f"[render] serve_prune_opacity auto -> {sp:.4f} (max probe err <= {tol:.4f})")
    sp = float(sp)
    if sp > 0:
        st = pruned_state(sp)
        n0, n1 = int(alive0.sum()), int(st.aux.alive.sum())
        print(f"[render] serve-time prune: opacity < {sp:.4f} drops {n0 - n1} of {n0} gaussians")
        state = st
    return state


def render_sets(cfg: Config, state: Optional[TrainState] = None, scene: Optional[Scene] = None,
                device=None) -> Dict:
    """Offline rendering of the test and train splits with frame-rate
    measurement (ref: render.py:15-60). Each view renders at its own
    capacity from the ×1.5 ladder, picked by a demand probe
    (sum(tiles_touched) of screen_space, an exact upper bound on the
    instances), and regrows up the ladder (at most 8 times) when it still
    drops instances; at max_instance_capacity it renders with the drops
    and says so. cfg is not written. Returns render_ms / fps (the mean
    over the views but the first and any that regrew), fps_throughput
    (dispatch depth 8), and the per-view capacities and regrows."""
    device = resolve_device(device)
    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    scene = scene or build_trained_scene(cfg, device)
    if state is None:
        state = load_trained_state(cfg, scene, device)
    state = _serve_prune(cfg, scene, state)

    eval_render = make_eval_render(cfg, scene)
    # frozen parameters: the sky's window table once, for every view
    sky_table = None
    if state.params.sky is not None:
        with torch.no_grad():
            sky_table = build_sky_table(state.params.sky.cubemap)

    bucket_fns = {}
    default_cap = int(cfg.render.get("instance_capacity", 2**21))
    view_caps: Dict[int, int] = {}
    maxcap = int(cfg.render.get("max_instance_capacity", 2**23))
    ladder = capacity_ladder(maxcap)

    def render_fn_at(cap):
        if cap not in bucket_fns:
            c = copy.deepcopy(cfg)
            c.render.instance_capacity = cap
            bucket_fns[cap] = make_eval_render(c, scene)
        return bucket_fns[cap]

    def run_render(view):
        fn = render_fn_at(view_caps[id(view)]) if id(view) in view_caps else eval_render
        return fn(state.params, state.aux, view.frame_input, sky_table=sky_table)

    all_views = scene.test_views + scene.train_views
    out = {}
    if cfg.render.get("auto_size_capacity", True):
        opts0 = render_opts_from_cfg(cfg, "eval")
        for v in all_views:
            with torch.no_grad():
                screen, _ = screen_space(state.params, state.aux, scene.table, scene.pose_data, v.frame_input,
                                         EVAL_STEP, opts=opts0)
            need = max(int(screen.tiles_touched.sum()), 1024)
            view_caps[id(v)] = next((c for c in ladder if c >= need), maxcap)
        hist: Dict[int, int] = {}
        for c in view_caps.values():
            hist[c] = hist.get(c, 0) + 1
        print("[render] demand-adaptive capacities: " + ", ".join(f"{c}x{n}" for c, n in sorted(hist.items())))
        out["capacities"] = {str(c): n for c, n in sorted(hist.items())}
        out["view_capacities"] = {v.image_name: view_caps[id(v)] for v in all_views}
        # one render per bucket before the timed loop
        warmed = set()
        for v in all_views:
            if view_caps[id(v)] not in warmed:
                warmed.add(view_caps[id(v)])
                run_render(v)
        sync()

    trace_dir = cfg.render.get("trace_dir", None)
    prof = contextlib.nullcontext()
    if trace_dir:
        acts = [torch.profiler.ProfilerActivity.CPU] + ([torch.profiler.ProfilerActivity.CUDA] if cuda else [])
        prof = torch.profiler.profile(activities=acts)
    times, regrows = [], []
    with prof:
        for split, views, skip in (("test", scene.test_views, cfg.eval.skip_test),
                                   ("train", scene.train_views, cfg.eval.skip_train)):
            if skip or not views:
                continue
            split_dir = os.path.join(cfg.model_path, f"{split}_renders")
            os.makedirs(split_dir, exist_ok=True)
            for i, view in enumerate(views):
                sync()
                t0 = time.perf_counter()
                r = run_render(view)
                sync()
                t1 = time.perf_counter()
                regrown = False
                # instance overflow only: growing the instance capacity
                # cannot remove tile-capacity drops
                for _ in range(8):
                    dropped = int(r["overflow_instance"])
                    if dropped <= 0:
                        break
                    cur = view_caps.get(id(view), default_cap)
                    need = max(int((cur + dropped) * 1.3), cur * 2)
                    new_cap = next((c for c in ladder if c >= need), maxcap)
                    if new_cap <= cur:
                        print(f"[render] {view.image_name}: demand exceeds max_instance_capacity={maxcap} — "
                              f"rendering with {dropped} dropped instances")
                        break
                    print(f"[render] overflow at {view.image_name} ({dropped} dropped): view capacity {cur} -> "
                          f"{new_cap}")
                    view_caps[id(view)] = new_cap
                    regrown = True
                    regrows.append({"view": view.image_name, "from": cur, "to": new_cap, "dropped": dropped})
                    r = run_render(view)
                if i > 0 and not regrown:
                    times.append(t1 - t0)
                if cfg.render.get("save_image", True):
                    img = np.clip(r["rgb"].cpu().numpy() * 255, 0, 255).astype(np.uint8)
                    imwrite(os.path.join(split_dir, f"{view.image_name}_rgb.png"), img[..., ::-1])
    if trace_dir:
        os.makedirs(str(trace_dir), exist_ok=True)
        path = os.path.join(str(trace_dir), "render_sets_trace.json")
        prof.export_chrome_trace(path)
        print(f"[render] profiler trace written to {path}")
    if times:
        mean_ms = 1000.0 * sum(times) / len(times)
        print(f"average rendering time: {mean_ms:.2f} ms ({1000.0 / mean_ms:.2f} FPS)")
        out["render_ms"] = mean_ms
        out["fps"] = 1000.0 / mean_ms
    out["regrows"] = regrows

    # pipelined throughput: dispatch ahead, fetch behind, 8 deep
    tviews = all_views[:64]
    if len(tviews) >= 2:
        run_render(tviews[0])
        depth = 8
        sync()
        t0 = time.perf_counter()
        pending = []
        for view in tviews:
            rgb = run_render(view)["rgb"]
            ev = None
            if cuda:
                ev = torch.cuda.Event()
                ev.record()
            pending.append((rgb, ev))
            if len(pending) >= depth:
                _, ev0 = pending.pop(0)
                if ev0 is not None:
                    ev0.synchronize()
        sync()
        dt = time.perf_counter() - t0
        out["fps_throughput"] = len(tviews) / dt
        print(f"pipelined throughput: {out['fps_throughput']:.2f} frames/s ({len(tviews)} frames, dispatch depth "
              f"{depth})")
    return out


def render_trajectory(cfg: Config, state: Optional[TrainState] = None, scene: Optional[Scene] = None,
                      device=None) -> Dict:
    """Render every view in frame order (those of render.concat_cameras
    when it lists any) from the newest checkpoint: a full, an
    object-only and a background-only eval render each, written as the
    channels rgb, object, background, depth (visualize_depth) and acc
    under model_path/trajectory/: PNGs (render.save_image) and one video
    a channel (render.save_video, which needs OpenCV) (ref: render.py:62-85,
    street_gaussian_visualizer.py:12-181). The sky's window table is
    built once. Returns the number of frames and the directory."""
    device = resolve_device(device)
    scene = scene or build_trained_scene(cfg, device)
    if state is None:
        state = load_trained_state(cfg, scene, device)
    eval_full = make_eval_render(cfg, scene)
    eval_obj = make_eval_render(cfg, scene, render_object_mask(scene.table))
    eval_bkgd = make_eval_render(cfg, scene, render_background_mask(scene.table))
    sky_table = None
    if state.params.sky is not None:
        with torch.no_grad():
            sky_table = build_sky_table(state.params.sky.cubemap)

    views = sorted(scene.all_views, key=lambda v: (v.frame_idx, v.cam))
    concat = list(cfg.render.get("concat_cameras", []))
    if concat:
        views = [v for v in views if v.cam in concat]
    out_dir = os.path.join(cfg.model_path, "trajectory")
    vis = Visualizer(out_dir, save_image=cfg.render.get("save_image", True),
                     save_video=cfg.render.get("save_video", True), fps=cfg.render.get("fps", 24))
    host = lambda t: t.detach().cpu().numpy()  # noqa: E731
    for view in views:
        full, obj, bkgd = (fn(state.params, state.aux, view.frame_input, sky_table=sky_table)
                           for fn in (eval_full, eval_obj, eval_bkgd))
        vis.add("rgb", view.image_name, host(full["rgb"]))
        vis.add("object", view.image_name, host(obj["rgb"]))
        vis.add("background", view.image_name, host(bkgd["rgb"]))
        vis.add("depth", view.image_name, visualize_depth(host(full["depth"]))[0])
        vis.add("acc", view.image_name, host(full["acc"])[..., None].repeat(3, -1))
    vis.summarize()
    return {"num_frames": len(views), "out_dir": out_dir}


def evaluate_metrics(cfg: Config, device=None) -> Dict:
    """Offline PSNR and SSIM of the saved renders against the ground
    truth (ref: metrics.py:26-104), and LPIPS where its weights are found
    (utils/lpips.py; else none, and a line says so), per split, written
    to results_{split}.json."""
    device = resolve_device(device)
    scene = build_scene(cfg, device)
    gt_cache = GTCache(cfg.data.get("white_background", False), device=device)
    results = {}
    for split, views in (("test", scene.test_views), ("train", scene.train_views)):
        split_dir = os.path.join(cfg.model_path, f"{split}_renders")
        if not os.path.isdir(split_dir) or not views:
            continue
        per_view = []
        for view in views:
            p = os.path.join(split_dir, f"{view.image_name}_rgb.png")
            if not os.path.exists(p):
                continue
            pred = torch.as_tensor(np.ascontiguousarray(imread(p)[..., ::-1]).astype(np.float32) / 255.0,
                                   device=device)
            gt = gt_cache.get(view).image
            rec = {"name": view.image_name, "psnr": float(L.psnr(pred, gt)), "ssim": float(L.ssim(pred, gt))}
            lp = lpips_fn(pred, gt)
            if lp is not None:
                rec["lpips"] = lp
            per_view.append(rec)
        if per_view:
            results[split] = {
                "psnr": sum(v["psnr"] for v in per_view) / len(per_view),
                "ssim": sum(v["ssim"] for v in per_view) / len(per_view),
                "per_view": per_view,
            }
            if "lpips" in per_view[0]:
                results[split]["lpips"] = sum(v["lpips"] for v in per_view) / len(per_view)
            else:
                print(f"[metrics] {split}: no LPIPS weights found ($SGTPU_LPIPS_WEIGHTS or the torch hub "
                      "cache): PSNR and SSIM only")
            with open(os.path.join(cfg.model_path, f"results_{split}.json"), "w") as f:
                json.dump(results[split], f, indent=2)
    return results
