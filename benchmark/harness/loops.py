"""What the loops share, and the two loops of the first cells: the train
cycles and the closed-loop serve, driven by a traffic file's
parameters (benchmark/loops/<name>.py names the loop a traffic file
asks for).

A run: set-up (the scene and its ground truth made from the seed, the
program built, its kernels built on the first run in a checkout, the
checked first steps and densify round or the warm-up views, a warm-up
of every shape the window uses), the measured window, then (with
--trace 1) a profiled stretch and the replay that counts its work, and
last the reference's check. The program's state is freed before the
reference runs.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Callable, Dict, List, Optional

import torch

from benchmark.harness import check, program
from benchmark.harness.scene import make_generator, make_scene, make_truth
from benchmark.harness.stats import percentile


@dataclasses.dataclass
class Outcome:
    """What a run measured, for run.py to report."""

    attempted: int
    failed: int
    setup_s: float
    window_s: float
    e2e: Dict[str, float]  # the end-to-end readings
    numbers: Dict[str, float]  # compared against the reference
    limits: Dict[str, float]  # each compared number's limit (check.LIMITS)
    peak_bytes: int
    layer_ctx: Optional[dict] = None  # for the per-layer readers (--trace 1)
    device: Optional[dict] = None


class Feed:
    """Training views in seeded epochs: each epoch the training frames in
    a fresh seeded order, every camera of a frame in a seeded order, so
    that any stretch of steps holds the cameras in the same proportions
    whatever the seed (the reference shuffles all views; this keeps the
    work of a window the same from seed to seed)."""

    def __init__(self, views: List[int], seed: int, cams_of=None):
        self.g = make_generator(seed, torch.device("cpu"), stream=1)
        groups: Dict[int, List[int]] = {}
        for v in views:
            groups.setdefault(v if cams_of is None else cams_of(v), []).append(v)
        self.groups = list(groups.values())
        self.queue: List[int] = []

    def next(self) -> int:
        if not self.queue:
            for k in torch.randperm(len(self.groups), generator=self.g).tolist():
                grp = self.groups[k]
                self.queue += [grp[i] for i in torch.randperm(len(grp), generator=self.g).tolist()]
        return self.queue.pop(0)


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _profile(dev, fn: Callable[[], None]) -> str:
    """Run fn under torch.profiler inside the range bench_window; the
    Chrome trace's path (in TMPDIR; the caller deletes it)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    sync(dev)
    with profile(activities=acts) as prof:
        with record_function("bench_window"):
            fn()
            sync(dev)
    fd, path = tempfile.mkstemp(suffix=".json", prefix="bench_trace_")
    os.close(fd)
    prof.export_chrome_trace(path)
    return path


def _summary(path: str) -> dict:
    """The trace's summary over the profiled stretch (the bench_window
    range): device events inside it, its length."""
    from benchmark.harness import trace as tr

    events = tr.load_events(path)
    span = [e for e in events if e.get("name") == "bench_window" and e.get("cat") == "user_annotation"][0]
    return tr.summarize_events(events, span["ts"], span["ts"] + span["dur"])


class TrainSetup:
    """A train cell's program side: the scene, the program's objects,
    the window's call `one(state)` (the feed's next view, the step's
    draws, the step, the densify cadence), the snapshot."""

    def __init__(self, cell, seed: int, dev, trace: bool = False, fault: Optional[str] = None):
        cfg, tr = cell.config, cell.traffic
        self.cfg, self.dev = cfg, dev
        self.start_it, self.cycle = tr["start_iteration"], tr["cycle"]
        self.scene = make_scene(cfg["scene"], seed, dev, iteration=self.start_it)
        self.truths = {i: make_truth(self.scene, self.scene.views[i], dev) for i in self.scene.train_views}
        if dev.type == "cuda":
            program.build_kernels()
        self.prog = program.build(self.scene, cfg["recipe"], self.truths, dev)
        self.densify_s = 0.0
        self.step_fn, self.densify_fn, _, self.cadence = program.train_fns(
            self.prog, wrap=self._timed if trace else None)
        if fault == "densify_threshold":
            self.cadence = program.train_fns(program.with_thresholds(self.prog, 2.0))[3]
        elif fault is not None:
            self.step_fn = plant_train_fault(self.step_fn, fault)
        self.snapshot = self.prog.state
        self.feed = Feed(self.scene.train_views, seed, cams_of=lambda v: self.scene.views[v].frame_idx)
        self.g_draw = make_generator(seed, dev, stream=2)
        self.g_dens = make_generator(seed, dev, stream=3)
        self.flip_rows = self.prog.table.flip_prob[self.snapshot.aux.model_id]
        self.with_sky = self.snapshot.params.sky is not None
        self.bad = torch.zeros((), dtype=torch.int64, device=dev)

    def _timed(self, fn):
        def wrapped(*a, **kw):
            sync(self.dev)
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            sync(self.dev)
            self.densify_s += time.perf_counter() - t0
            return out
        return wrapped

    def one(self, st, record=None):
        i = self.feed.next()
        draws = program.make_draws(self.flip_rows, self.scene.H, self.scene.W, self.with_sky, self.g_draw)
        st, sc = self.step_fn(st, self.prog.frames[i], self.prog.truths[i], draws=draws)
        st, _ = self.cadence(st, st.step, self.g_dens)
        self.bad = self.bad + ((sc["overflow"] > 0) | ~torch.isfinite(sc["loss"])).to(torch.int64)
        if record is not None:
            record.append((i, draws, sc["loss"]))
        return st

    def densify_at_cycle_end(self) -> bool:
        """Whether the cadence runs a densify round at the cycle's last
        iteration."""
        o = self.prog.cfg.optim
        it = self.start_it + self.cycle
        return o.densify_from_iter < it < o.densify_until_iter and it % o.densification_interval == 0

    def checked_densify(self, state, seed: int):
        """The cadence at the cycle's last iteration, through the
        window's own call, on the checked steps' state and statistics:
        (the program's side of the densify numbers, the round's draws as
        the program takes them from the generator)."""
        g = make_generator(seed, self.dev, stream=4)
        noise = program.densify_draws(self.scene.capacity, make_generator(seed, self.dev, stream=4))
        aux, gs = state.aux, state.params.gaussians
        side = {"stats": {"grad": aux.grad_accum[:, 0].clone(), "absgrad": aux.grad_accum[:, 1].clone(),
                          "denom": aux.denom.clone(), "max_radii": aux.max_radii.clone()},
                "alive0": aux.alive.clone(), "xyz0": gs.xyz.clone()}
        new, diag = self.cadence(state, self.start_it + self.cycle, g)
        side.update(alive=new.aux.alive.clone(), xyz=new.params.gaussians.xyz.clone(),
                    log_scale=new.params.gaussians.log_scale.clone(), n_split=int(diag["points_split"]),
                    n_clone=int(diag["points_clone"]))
        return side, noise

    def checked_steps(self, n: int):
        """The first n steps from the snapshot through `one`: (state,
        [(view, draws, loss)], the losses, the first step's gradient
        norms as Adam got them, the norms of the parameters' change)."""
        from street_gaussians_torch.train_lib import flatten_params

        state = program.clone_state(self.snapshot)
        p0 = {k: v.clone() for k, v in flatten_params(self.snapshot.params).items()}
        mu0 = {k: v.clone() for k, v in self.snapshot.adam.mu.items()}
        rec: list = []
        g: Dict[str, float] = {}
        for k in range(n):
            state = self.one(state, rec)
            if k == 0:
                g = {name: float(((state.adam.mu[name] - 0.9 * mu0[name]) / 0.1).double().norm()) for name in mu0}
        dp = {name: float((v - p0[name]).double().norm()) for name, v in flatten_params(state.params).items()}
        return state, rec, [float(x) for _, _, x in rec], g, dp


@dataclasses.dataclass
class RefSteps:
    """The reference's checked steps."""

    losses: List[float]
    g: Dict[str, float]  # the first step's gradient norms
    dp: Dict[str, float]  # the norms of the parameters' change
    params: Dict[str, torch.Tensor]  # after the steps
    stats: Optional[Dict[str, torch.Tensor]]  # the densification statistics, summed over the steps


def reference_train(scene, cfg: dict, start_it: int, rec, truths, tf32: bool = False, half: bool = False,
                    frozen: bool = False, statistics: bool = False) -> RefSteps:
    """The reference's steps on the recorded views and draws. tf32: the
    control (matrix products in TF32); half: a fault, the loss over the
    top half of the image; frozen: a fault, every step returns the state
    it was given (and adds no statistics); statistics: sum the
    densification statistics."""
    from benchmark.reference import densify as ref_densify
    from benchmark.reference import train as ref_train
    from benchmark.reference.render import precise

    o = cfg["recipe"]["optim"]
    obj_loss = start_it >= o["densify_until_iter"] and o.get("lambda_reg", 0) > 0
    rs = ref_train.initial_state(scene)
    p0 = {k: v.clone() for k, v in rs["params"].items()}
    losses, g = [], {}
    acc = ref_densify.zero_statistics(scene.capacity, scene.model_id.device) if statistics else None
    precise(not tf32)
    try:
        for k, (i, draws, _) in enumerate(rec):
            new, loss, grads, st = ref_train.step(scene, rs, cfg["recipe"], scene.views[i], truths[i], draws.flip,
                                                  draws.sky_jitter, obj_loss, half=half, statistics=statistics)
            if not frozen:
                rs = new
                if statistics:
                    acc = ref_densify.accumulate(acc, st)
            else:
                rs = dict(rs, step=new["step"])
                grads = {n: torch.zeros_like(v) for n, v in grads.items()}
            losses.append(float(loss))
            if k == 0:
                g = check.leaf_norms(grads)
            del grads, st
    finally:
        precise(True)
    dp = {n: float((v - p0[n]).double().norm()) for n, v in rs["params"].items()}
    return RefSteps(losses=losses, g=g, dp=dp, params=rs["params"], stats=acc)


def reference_densify(scene, cfg: dict, iteration: int, ref: RefSteps, noise, threshold_scale: float = 1.0):
    """The reference's densify round at `iteration` on its own steps'
    parameters and statistics, with the program's draws."""
    from benchmark.reference import densify as ref_densify

    o = cfg["recipe"]["optim"]
    return ref_densify.densify(scene, o, ref.params, scene.alive, ref.stats, noise,
                               prune_big=iteration > o["opacity_reset_interval"], threshold_scale=threshold_scale)


def run_train(cell, seed: int, seconds: float, trace: bool, dev, t_start: float,
              fault: Optional[str] = None) -> Outcome:
    tr = cell.traffic
    S = TrainSetup(cell, seed, dev, trace, fault)
    start_it, cycle = S.start_it, S.cycle
    # ---- the checked first steps, through the window's call and feed ----
    state, checked, prog_losses, prog_g, prog_dp = S.checked_steps(tr["checked_steps"])
    checked_bad = int(S.bad)
    # ---- the checked densify round (the cycle's last cadence call), a restore: the rest of the window's work ----
    dens = S.checked_densify(state, seed) if S.densify_at_cycle_end() else None
    program.clone_state(S.snapshot)
    sync(dev)
    setup_s = time.perf_counter() - t_start

    # ---- the window ----
    S.bad = torch.zeros((), dtype=torch.int64, device=dev)
    S.densify_s = 0.0
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
        layer_ctx, device_extra = _train_layer_ctx(path, n, clock / steps, S.densify_s / steps, S.scene, S.prog,
                                                   S.step_fn, replay_from, rec, dev)
        os.unlink(path)
    scene, cfg = S.scene, S.cfg
    truths_used = {i: S.truths[i] for i, _, _ in checked}
    del state, S
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # ---- the reference's steps and densify round ----
    ref = reference_train(scene, cfg, start_it, checked, truths_used, statistics=dens is not None)
    numbers = check.train_numbers(prog_losses, ref.losses, prog_g, ref.g, prog_dp, ref.dp)
    limits = dict(check.LIMITS["train"])
    if dens is not None:
        side, noise = dens
        numbers.update(check.densify_numbers(side, ref.stats,
                                             reference_densify(scene, cfg, start_it + cycle, ref, noise)))
        limits.update(check.LIMITS["densify"])
    numbers["checked_failed"] = checked_bad
    limits["checked_failed"] = 0
    return Outcome(attempted=steps, failed=failed, setup_s=setup_s, window_s=clock,
                   e2e={"train_step_ms": 1e3 * clock / steps}, numbers=numbers, limits=limits, peak_bytes=peak,
                   layer_ctx=layer_ctx, device=device_extra)


def plant_train_fault(step_fn, fault: str):
    """A step with a fault of the kind the check must catch (tests only):
    "unchanged" returns its state as it came; "half_batch" trains on the
    top half of the image, the mean over it. (TrainSetup plants
    "densify_threshold": the densify round's thresholds doubled.)"""
    import dataclasses as dc

    def unchanged(state, frame, gt, **kw):
        _, sc = step_fn(state, frame, gt, **kw)
        return dc.replace(state, step=state.step + 1), sc

    def half_batch(state, frame, gt, **kw):
        H = gt.image.shape[0] // 2
        cam = dc.replace(frame.cam, H=H)
        draws = kw.get("draws")
        if draws is not None and draws.sky_jitter is not None:
            kw["draws"] = draws._replace(sky_jitter=draws.sky_jitter[:H])
        gt_h = dc.replace(gt, image=gt.image[:H], mask=gt.mask[:H], sky_mask=gt.sky_mask[:H],
                          lidar_depth=gt.lidar_depth[:H], obj_bound=gt.obj_bound[:H])
        return step_fn(state, dc.replace(frame, cam=cam), gt_h, **kw)

    return {"unchanged": unchanged, "half_batch": half_batch}[fault]


def _train_layer_ctx(path, n, step_s, densify_per_step_s, scene, prog, step_fn, replay_from, rec, dev):
    """The per-layer readers' inputs: the trace and the profiled steps'
    work, counted by replaying them (the program's steps are
    deterministic) and counting each step's inputs with the reference."""
    from street_gaussians_torch.train_lib import flatten_params

    from benchmark.harness import trace as tr
    from benchmark.reference.render import render

    obj = prog.cfg.optim.lambda_reg > 0 and replay_from.step >= prog.cfg.optim.densify_until_iter \
        and len(scene.models.names) > 1
    work = {"evaluated": 0, "blended": 0, "live": 0, "tiles": 0, "rows": 0, "pixels": 0, "sky_pixels": 0,
            "adam_elements": 0, "payload_live": [], "capacity": scene.capacity,
            "texels": int(prog.state.params.sky.cubemap.shape[1]) if prog.state.params.sky is not None else 0}
    st = replay_from
    wb = bool(prog.cfg.data.get("white_background", False))
    for i, draws, _ in rec:
        p = {k: v.detach() for k, v in flatten_params(st.params).items()}
        renders = [dict()] + ([dict(models=range(1, len(scene.models.names)), with_sky=False)] if obj else [])
        for kw in renders:
            with torch.no_grad():
                out = render(scene, p, scene.views[i], train=True, flip=draws.flip, jitter=draws.sky_jitter,
                             white_background=wb, count=True, alive=st.aux.alive, **kw)
            c = out["counts"]
            work["evaluated"] += c["evaluated"]
            work["blended"] += c["blended"]
            work["live"] += c["instances"]
            work["tiles"] += c["tiles"]
            work["payload_live"].append(c["instances"])
            if not kw:
                work["rows"] += out["alive_rows"]
            del out
        work["pixels"] += scene.H * scene.W
        work["sky_pixels"] += scene.H * scene.W if st.params.sky is not None else 0
        width = sum(v[0].numel() for k, v in flatten_params(st.params).items() if k.startswith("gaussians."))
        rows_in_play = int(st.aux.alive.sum())
        work["adam_elements"] += rows_in_play * width + sum(
            v.numel() for k, v in flatten_params(st.params).items() if not k.startswith("gaussians."))
        st, _ = step_fn(st, prog.frames[i], prog.truths[i], draws=draws)
    sm = _summary(path)
    lo, hi = sm["lo_us"], sm["hi_us"]
    ctx = {"kind": "train", "steps": n, "unprofiled_s": step_s, "densify_s": densify_per_step_s,
           "trace": sm, "work": {k: (v / n if isinstance(v, int) and k not in ("capacity", "texels") else v)
                                 for k, v in work.items()}}
    device = {"busy_s": sm["busy_ms"] / 1e3, "window_s": sm["window_ms"] / 1e3,
              "breakdown": {"device_ops": tr.top_ops(sm["dev"]),
                            "idle_gaps": tr.idle_gaps(sm["events"], sm["dev"], lo, hi)}}
    return ctx, device


def sample_views(n_views: int, k: int, g: torch.Generator) -> List[int]:
    """The positions in a pass of the served views kept for the
    comparison: k drawn from the seed among the first two thirds of the
    pass, so that they are due well inside any window that holds a
    pass."""
    return sorted(torch.randperm(max(k, 2 * n_views // 3), generator=g)[:k].tolist())


def served_views(scene, which: str) -> List[int]:
    """The views a pass serves, frame-major (every camera of a frame,
    frames in order): "all", the training views ("train") or the
    held-out ones ("test")."""
    train = set(scene.train_views)
    pick = {"all": lambda i: True, "train": lambda i: i in train, "test": lambda i: i not in train}
    if which not in pick:
        raise SystemExit(f"unknown views {which!r}: all, train or test")
    return [i for i in range(len(scene.views)) if pick[which](i)]


def run_serve(cell, seed: int, seconds: float, trace: bool, dev, t_start: float,
              fault: Optional[str] = None) -> Outcome:
    from benchmark.reference.render import precise, render

    cfg, tr = cell.config, cell.traffic
    scene = make_scene(cfg["scene"], seed, dev, iteration=cfg["scene"]["snapshot_iteration"])
    if dev.type == "cuda":
        program.build_kernels()
    prog = program.build(scene, cfg["recipe"], {}, dev)
    render_fn, sky_table = program.eval_render(prog)
    params, aux = prog.state.params, prog.state.aux
    views = served_views(scene, tr["views"])
    g = make_generator(seed, torch.device("cpu"), stream=5)
    sample = {views[k] for k in sample_views(len(views), tr["sample_views"], g)}
    kept: Dict[int, tuple] = {}
    bad = torch.zeros((), dtype=torch.int64, device=dev)

    def serve(i: int):
        nonlocal bad
        out = render_fn(params, aux, prog.frames[i], sky_table=sky_table)
        rgb8 = check.to_uint8(out["rgb"])
        if fault in ("tile", "tile_rgb"):  # one 16x16 tile of the answer altered where it is made
            rgb8[:16, :16] = 255 - rgb8[:16, :16]
        if fault == "tile":  # ... and its acc and depth
            out = dict(out, acc=out["acc"].clone(), depth=out["depth"].clone())
            out["acc"][:16, :16] = 1.0 - out["acc"][:16, :16]
            out["depth"][:16, :16] = 2.0 * out["depth"][:16, :16] + 1.0
        bad = bad + ((out["overflow"] > 0) | ~torch.isfinite(out["rgb"]).all()).to(torch.int64)
        host = rgb8.cpu()
        return out, host

    for i in views[:2]:  # warm-up: every view has the same shape
        serve(i)
    sync(dev)
    setup_s = time.perf_counter() - t_start

    bad = torch.zeros((), dtype=torch.int64, device=dev)
    lat: List[float] = []
    pos = 0
    t_begin = time.perf_counter()
    while time.perf_counter() - t_begin < seconds:
        i = views[pos % len(views)]
        pos += 1
        t0 = time.perf_counter()
        out, host = serve(i)
        lat.append(time.perf_counter() - t0)
        if i in sample and i not in kept:
            kept[i] = (host, out["acc"].clone(), out["depth"].clone())
    window = time.perf_counter() - t_begin
    failed = int(bad)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    layer_ctx, device_extra = None, None
    if trace:
        n = tr["profiled_views"]
        first = pos
        path = _profile(dev, lambda: [serve(views[(first + k) % len(views)]) for k in range(n)])
        layer_ctx, device_extra = _serve_layer_ctx(path, n, window / len(lat), scene, prog,
                                                   [views[(first + k) % len(views)] for k in range(n)], dev)
        os.unlink(path)
    del prog, params, aux, render_fn, sky_table
    torch.cuda.empty_cache() if dev.type == "cuda" else None

    # ---- the reference's renders of the sampled views ----
    from benchmark.reference.train import initial_state

    p = initial_state(scene)["params"]
    worst: Dict[str, float] = {}
    precise(True)
    for i, (rgb8, acc, depth) in kept.items():
        with torch.no_grad():
            ref = render(scene, p, scene.views[i], train=False,
                         white_background=bool(cfg["recipe"]["data"].get("white_background", False)))
        for k, v in check.view_numbers(rgb8, acc, depth, ref).items():
            worst[k] = max(worst.get(k, 0.0), v)
    numbers = dict(worst) if kept else {k: float("nan") for k in check.LIMITS["serve"]}
    numbers["views_compared"] = len(kept)
    return Outcome(attempted=len(lat), failed=failed, setup_s=setup_s, window_s=window,
                   e2e={"serve_views_per_s": len(lat) / window, "serve_view_ms_p95": 1e3 * percentile(lat, 95)},
                   numbers=numbers, limits=dict(check.LIMITS["serve"]), peak_bytes=peak, layer_ctx=layer_ctx,
                   device=device_extra)


def _serve_layer_ctx(path, n, view_s, scene, prog, served, dev):
    from street_gaussians_torch.train_lib import flatten_params

    from benchmark.harness import trace as tr
    from benchmark.reference.render import render

    p = {k: v.detach() for k, v in flatten_params(prog.state.params).items()}
    work = {"evaluated": 0, "blended": 0, "live": 0, "tiles": 0, "rows": 0, "pixels": 0, "sky_pixels": 0}
    wb = bool(prog.cfg.data.get("white_background", False))
    for i in served:
        with torch.no_grad():
            out = render(scene, p, scene.views[i], train=False, white_background=wb, count=True)
        c = out["counts"]
        for k in ("evaluated", "blended", "tiles"):
            work[k] += c[k]
        work["live"] += c["instances"]
        work["rows"] += out["alive_rows"]
        work["pixels"] += scene.H * scene.W
        work["sky_pixels"] += scene.H * scene.W if "sky.cubemap" in p else 0
    sm = _summary(path)
    lo, hi = sm["lo_us"], sm["hi_us"]
    ctx = {"kind": "serve", "steps": n, "unprofiled_s": view_s, "trace": sm,
           "work": {k: v / n for k, v in work.items()}}
    device = {"busy_s": sm["busy_ms"] / 1e3, "window_s": sm["window_ms"] / 1e3,
              "breakdown": {"device_ops": tr.top_ops(sm["dev"]),
                            "idle_gaps": tr.idle_gaps(sm["events"], sm["dev"], lo, hi)}}
    return ctx, device
