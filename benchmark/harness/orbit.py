"""The static scene's train cycles (harness/orbit_scene.py's garden):
the program built as the port's Colmap data type builds a scene, the
window's train cycles as harness/loops.run_train drives the street's,
and the comparison with reference/sh.py.

The program sees what `runner.build_scene` gives for `data.type`
Colmap (data/static_readers.py): one model, the background, over the
whole table, no actors (no pose data or parameters), no sky, a frame
input a view with the identity ego pose and no actor interpolation,
ground truth with no sky mask, LiDAR depth or actor boxes. The step
and the cadence are the street cells' (program.train_fns:
`train_lib.make_train_step` and `densify_cadence`, as
`runner.training` calls them).
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Optional

import numpy as np
import torch

from benchmark.harness import check, program
from benchmark.harness.loops import Feed, Outcome, TrainSetup, _profile, _summary, plant_train_fault, sync
from benchmark.harness.orbit_scene import OrbitScene, make_scene, make_truth
from benchmark.harness.scene import SH_C0, make_generator

# The cell's limits of `correct`: the train cells' loss_gap
# (check.LIMITS), grad_gap and change_gap its own. The street's 0.05 and
# 0.012 lie above the TF32 control's lowest garden readings; 2e-3 and
# 1e-3 lie between the program's readings and the control's with room
# on both sides (PERF.md gives both).
LIMITS = {**check.LIMITS["train"], "grad_gap": 2e-3, "change_gap": 1e-3}


def loader_inputs(scene: OrbitScene, cfg) -> tuple:
    """What the Colmap loader hands its scene build
    (data/static_readers._build_static_scene), for the orbit: the views'
    entries (K, c2w, image path, width, height, name), the seed cloud's
    points and colours (the first capacity / background_growth alive
    rows) and split_test."""
    rows = scene.alive.nonzero()[: int(scene.capacity / cfg.capacity.background_growth), 0]
    xyz = scene.xyz[rows].double().cpu().numpy()
    rgb = (scene.feat_dc[rows, 0] * SH_C0 + 0.5).clamp(0, 1).cpu().numpy()
    entries = [(scene.K, np.linalg.inv(v.w2c), f"view_{v.index:03d}", scene.W, scene.H, f"view_{v.index:03d}")
               for v in scene.views]
    return entries, xyz, rgb, cfg.data.get("split_test", 8)


def build(scene: OrbitScene, recipe: dict, truths: dict, device) -> program.Program:
    """The program's objects for the static scene, made by the Colmap
    loader's own scene build (data/static_readers._build_static_scene:
    the table, the norms, the views' cameras) from the orbit's cameras
    and a seed cloud, then given the snapshot's rows and Adam state. The
    seed cloud stands for the COLMAP points the loader packs: the first
    capacity / background_growth alive rows, so that the loader's
    capacity is the snapshot's up to its rounding to capacity.round_to
    rows (exact at the configuration's 6,291,456; a toy's capacity may
    fall between two roundings, and the table takes the snapshot's)."""
    from street_gaussians_torch.data.static_readers import _build_static_scene
    from street_gaussians_torch.models import gaussians as G
    from street_gaussians_torch.models.renderer import SceneParams
    from street_gaussians_torch.optim.adam import AdamState
    from street_gaussians_torch.runner import render_opts_from_cfg
    from street_gaussians_torch.train_lib import GroundTruth, init_train_state

    dev = torch.device(device)
    cfg = program.load_recipe(recipe)
    C = scene.capacity
    built = _build_static_scene(cfg, *loader_inputs(scene, cfg), dev)
    if abs(built.table.capacity - C) >= cfg.capacity.round_to or built.table.num_actors != 0:
        raise ValueError(f"the loader packs {built.table.capacity} rows from the seed cloud; the snapshot holds {C}")
    table = dataclasses.replace(built.table, slices=scene.models.slices.copy(), capacity=C)
    views = sorted(built.train_views + built.test_views, key=lambda v: v.frame)
    if [v.is_val for v in views] != [i not in set(scene.train_views) for i in range(len(scene.views))]:
        raise ValueError("the loader's held-out views are not the scene's")
    c = lambda x: x.clone()  # noqa: E731
    gp = G.GaussianParams(xyz=c(scene.xyz), feat_dc=c(scene.feat_dc), feat_rest=c(scene.feat_rest),
                          log_scale=c(scene.log_scale), rot=c(scene.rot), opacity_logit=c(scene.opacity_logit),
                          semantic=c(scene.semantic))
    aux = G.GaussianAux(alive=c(scene.alive), model_id=c(scene.model_id), grad_accum=torch.zeros((C, 2), device=dev),
                        denom=torch.zeros(C, device=dev), max_radii=torch.zeros(C, device=dev))
    del built
    params = SceneParams(gaussians=gp, actor_pose=None, sky=None, color_correction=None, pose_correction=None)
    state = init_train_state(params, aux)
    nu = {k: c(scene.adam_nu[k]) for k in state.adam.nu}
    count = {k: scene.alive.to(v.dtype) * scene.adam_count for k, v in state.adam.count.items()}
    state = type(state)(params=state.params, adam=AdamState(mu=state.adam.mu, nu=nu, count=count), aux=state.aux,
                        step=scene.adam_count)
    H, W = scene.H, scene.W
    gts = {i: GroundTruth(image=tr.image, mask=torch.ones((H, W, 1), dtype=torch.bool, device=dev),
                          sky_mask=torch.zeros((H, W, 1), dtype=torch.bool, device=dev),
                          lidar_depth=torch.zeros((H, W), device=dev),
                          obj_bound=torch.zeros((H, W, 1), dtype=torch.bool, device=dev),
                          sky_scale=torch.tensor(1.0, device=dev))
           for i, tr in truths.items()}
    return program.Program(cfg=cfg, table=table, pose_data=None, state=state,
                           frames=[v.frame_input for v in views], truths=gts,
                           opts_train=render_opts_from_cfg(cfg, "train"))


class OrbitSetup(TrainSetup):
    """TrainSetup's window call, feed and checked steps on the static
    scene: one training view a step in seeded epochs."""

    def __init__(self, cell, seed: int, dev, trace: bool = False, fault: Optional[str] = None):
        cfg, tr = cell.config, cell.traffic
        self.cfg, self.dev = cfg, dev
        self.start_it, self.cycle = tr["start_iteration"], tr["cycle"]
        self.scene = make_scene(cfg["scene"], seed, dev, iteration=self.start_it)
        self.truths = {i: make_truth(self.scene, self.scene.views[i], dev) for i in self.scene.train_views}
        if dev.type == "cuda":
            program.build_kernels()
        self.prog = build(self.scene, cfg["recipe"], self.truths, dev)
        self.densify_s = 0.0
        self.step_fn, self.densify_fn, _, self.cadence = program.train_fns(
            self.prog, wrap=self._timed if trace else None)
        if fault is not None:
            self.step_fn = plant_train_fault(self.step_fn, fault)
        self.snapshot = self.prog.state
        self.feed = Feed(self.scene.train_views, seed)
        self.g_draw = make_generator(seed, dev, stream=2)
        self.g_dens = make_generator(seed, dev, stream=3)
        self.flip_rows = self.prog.table.flip_prob[self.snapshot.aux.model_id]
        self.with_sky = False
        self.bad = torch.zeros((), dtype=torch.int64, device=dev)


def reference_train(scene, cfg: dict, rec, truths, tf32: bool = False, half: bool = False,
                    frozen: bool = False) -> "RefSteps":
    """reference/sh.py's steps on the recorded views. tf32: the control
    (matrix products in TF32); half: a fault, the loss over the top half
    of the image; frozen: a fault, every step returns its state."""
    from benchmark.harness.loops import RefSteps
    from benchmark.reference import sh as ref_sh
    from benchmark.reference.render import precise

    rs = ref_sh.initial_state(scene)
    p0 = {k: v.clone() for k, v in rs["params"].items()}
    losses, g = [], {}
    precise(not tf32)
    try:
        for k, (i, _, _) in enumerate(rec):
            new, loss, grads = ref_sh.step(scene, rs, cfg["recipe"], scene.views[i], truths[i].image, half=half)
            if frozen:
                rs = dict(rs, step=new["step"])
                grads = {n: torch.zeros_like(v) for n, v in grads.items()}
            else:
                rs = new
            losses.append(float(loss))
            if k == 0:
                g = check.leaf_norms(grads)
            del grads
    finally:
        precise(True)
    dp = {n: float((v - p0[n]).double().norm()) for n, v in rs["params"].items()}
    return RefSteps(losses=losses, g=g, dp=dp, params=rs["params"], stats=None)


def run(cell, seed: int, seconds: float, trace: bool, dev, t_start: float, fault: Optional[str] = None) -> Outcome:
    tr = cell.traffic
    S = OrbitSetup(cell, seed, dev, trace, fault)
    start_it, cycle = S.start_it, S.cycle
    # ---- the checked first steps, through the window's call and feed; a restore ----
    state, checked, prog_losses, prog_g, prog_dp = S.checked_steps(tr["checked_steps"])
    checked_bad = int(S.bad)
    program.clone_state(S.snapshot)
    sync(dev)
    setup_s = time.perf_counter() - t_start

    # ---- the window ----
    S.bad = torch.zeros((), dtype=torch.int64, device=dev)
    steps, clock = 0, 0.0
    t0 = time.perf_counter()
    while True:
        state = S.one(state)
        steps += 1
        if state.step >= start_it + cycle:
            sync(dev)
            clock += time.perf_counter() - t0
            state = program.clone_state(S.snapshot)
            sync(dev)
            t0 = time.perf_counter()
        if clock + time.perf_counter() - t0 >= seconds:
            break
    sync(dev)
    clock += time.perf_counter() - t0
    failed = int(S.bad)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    layer_ctx, device_extra = None, None
    if trace:
        n = tr["profiled_steps"]
        if state.step + n >= start_it + cycle:
            state = program.clone_state(S.snapshot)
        replay_from = program.clone_state(state)
        rec: list = []

        def stretch():
            nonlocal state
            for _ in range(n):
                state = S.one(state, rec)

        path = _profile(dev, stretch)
        layer_ctx, device_extra = layer_context(path, n, clock / steps, S, replay_from, rec)
        os.unlink(path)
    scene, cfg = S.scene, S.cfg
    truths_used = {i: S.truths[i] for i, _, _ in checked}
    del state, S
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    ref = reference_train(scene, cfg, checked, truths_used)
    numbers = check.train_numbers(prog_losses, ref.losses, prog_g, ref.g, prog_dp, ref.dp)
    limits = dict(LIMITS)
    numbers["checked_failed"] = checked_bad
    limits["checked_failed"] = 0
    return Outcome(attempted=steps, failed=failed, setup_s=setup_s, window_s=clock,
                   e2e={"train_step_ms": 1e3 * clock / steps}, numbers=numbers, limits=limits, peak_bytes=peak,
                   layer_ctx=layer_ctx, device=device_extra)


def layer_context(path, n, step_s, S, replay_from, rec):
    """The per-layer readers' inputs, as loops._train_layer_ctx gives
    the street's: the trace and the profiled steps' work, counted by
    replaying them (the program's steps repeat bit for bit) and counting
    each step's inputs with the reference."""
    from street_gaussians_torch.train_lib import flatten_params

    from benchmark.harness import trace as tr
    from benchmark.reference import sh as ref_sh

    scene, prog = S.scene, S.prog
    work = {"evaluated": 0, "blended": 0, "live": 0, "tiles": 0, "rows": 0, "pixels": 0, "sky_pixels": 0,
            "adam_elements": 0, "payload_live": [], "capacity": scene.capacity, "texels": 0}
    st = replay_from
    wb = bool(prog.cfg.data.get("white_background", False))
    for i, draws, _ in rec:
        p = {k: v.detach() for k, v in flatten_params(st.params).items()}
        with torch.no_grad():
            out = ref_sh.render(scene, p, scene.views[i], step=st.step, white_background=wb, count=True,
                                alive=st.aux.alive)
        c = out["counts"]
        for k in ("evaluated", "blended", "tiles"):
            work[k] += c[k]
        work["live"] += c["instances"]
        work["payload_live"].append(c["instances"])
        work["rows"] += out["alive_rows"]
        work["pixels"] += scene.H * scene.W
        del out
        width = sum(v[0].numel() for v in p.values())
        work["adam_elements"] += int(st.aux.alive.sum()) * width
        st, _ = S.step_fn(st, prog.frames[i], prog.truths[i], draws=draws)
    sm = _summary(path)
    ctx = {"kind": "train", "steps": n, "unprofiled_s": step_s, "densify_s": 0.0,
           "trace": sm, "work": {k: (v / n if isinstance(v, int) and k not in ("capacity", "texels") else v)
                                 for k, v in work.items()}}
    device = {"busy_s": sm["busy_ms"] / 1e3, "window_s": sm["window_ms"] / 1e3,
              "breakdown": {"device_ops": tr.top_ops(sm["dev"]),
                            "idle_gaps": tr.idle_gaps(sm["events"], sm["dev"], sm["lo_us"], sm["hi_us"])}}
    return ctx, device


def readings(cell, seed: int, dev, faults: bool = True) -> dict:
    """The numbers of `correct` for the program, the control (the
    reference in TF32) and, with `faults`, the planted faults (the loss
    over half the image, a state left unchanged), each against the
    reference."""
    S = OrbitSetup(cell, seed, dev)
    _, rec, pl, pg, pdp = S.checked_steps(cell.traffic["checked_steps"])
    scene, cfg = S.scene, S.cfg
    truths = {i: S.truths[i] for i, _, _ in rec}
    del S
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ref = reference_train(scene, cfg, rec, truths)
    out = {"program": check.train_numbers(pl, ref.losses, pg, ref.g, pdp, ref.dp)}
    sides = (("control", {"tf32": True}), ("fault_half_batch", {"half": True}), ("fault_unchanged", {"frozen": True}))
    for name, kw in sides if faults else sides[:1]:
        r = reference_train(scene, cfg, rec, truths, **kw)
        out[name] = check.train_numbers(r.losses, ref.losses, r.g, ref.g, r.dp, ref.dp)
    out["ref_grad_norms"] = ref.g
    return out
