"""Camera data parallel training cycles: one camera a rank, a batch of
`ranks` views a step (train.batch_size), through
`parallel.dp.make_data_parallel_train_step` over a `parallel.comm` group:
NCCL with a card a rank, Gloo where the ranks share a card
(comm.choose_backend).

Rank 0 runs in run.py's process on cuda:0 and starts ranks 1 .. ranks - 1
itself (torch.multiprocessing, spawn), rank r on cuda:r (cuda:0 for all
on a machine with one card); they form the group through a file in
TMPDIR. Every rank makes the same scene and ground truth from the seed,
builds the program and walks the same seeded epochs: each step takes
the next `ranks` training views, draws every camera's flip and sky
jitter from one generator (as train_lib.take_draws does) and trains its
own. Rank 0 keeps the clock, as harness/loops.run_train does for one
card; when the window's seconds are up it writes the window's last
step, STOP_MARGIN steps on, into memory the ranks share, which every
rank reads after each step without waiting on the others (no host
barrier a step). With --trace 1 every rank runs the profiled steps,
rank 0 under the profiler. `peak_mem_gib` is the largest over the
ranks.

`correct`: the first checked_steps batched steps from the snapshot and
the cycle's densify round, on rank 0, against reference/batch.py (each
step the mean of the batch's single-view reference gradients) and
reference/densify.py.
"""

from __future__ import annotations

import os
import tempfile
import time
from typing import List

import torch

from benchmark.harness import check, program
from benchmark.harness.loops import Outcome, RefSteps, TrainSetup, _profile, _summary, reference_densify, sync

TIMEOUT_S = 600
# steps the window runs on past rank 0's reading of its clock: no rank's
# host gets a step ahead of the others' (each step's reduction and the
# host syncs after it hold them together), so every rank reads the last
# step before it reaches it
STOP_MARGIN = 4


def rank_device(rank: int) -> torch.device:
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return torch.device("cuda", rank % n) if n else torch.device("cpu")


class BatchSetup(TrainSetup):
    """TrainSetup on one rank of the camera group: the data parallel step
    in the window's call, `ranks` views a step."""

    def __init__(self, cell, seed: int, dev, group, trace: bool = False):
        super().__init__(cell, seed, dev, trace)
        from street_gaussians_torch.parallel.dp import make_data_parallel_train_step

        self.group = group
        self.prog.cfg.train.batch_size = group.size
        self.step_fn = make_data_parallel_train_step(self.prog.cfg, self.prog.table, self.prog.pose_data,
                                                     self.prog.opts_train, group)

    def one(self, st, record=None):
        B = self.group.size
        views = [self.feed.next() for _ in range(B)]
        draws = [program.make_draws(self.flip_rows, self.scene.H, self.scene.W, self.with_sky, self.g_draw)
                 for _ in range(B)]
        i = views[self.group.rank]
        st, sc = self.step_fn(st, self.prog.frames[i], self.prog.truths[i], draws=draws[self.group.rank])
        st, _ = self.cadence(st, st.step, self.g_dens)
        self.bad = self.bad + ((sc["overflow"] > 0) | ~torch.isfinite(sc["loss"])).to(torch.int64)
        if record is not None:
            record.append((views, draws, sc["loss"]))
        return st


def reference_train(scene, cfg: dict, start_it: int, rec, truths, tf32: bool = False,
                    statistics: bool = False) -> RefSteps:
    """reference/batch.py's steps on the recorded batches and draws."""
    from benchmark.reference import batch as ref_batch
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
        for k, (views, draws, _) in enumerate(rec):
            rs, loss, grads, st = ref_batch.step(
                scene, rs, cfg["recipe"], [scene.views[i] for i in views], [truths[i] for i in views],
                [d.flip for d in draws], [d.sky_jitter for d in draws], obj_loss, statistics=statistics)
            if statistics:
                acc = {n: (torch.maximum(acc[n], st[n]) if n == "max_radii" else acc[n] + st[n]) for n in acc}
            losses.append(float(loss))
            if k == 0:
                g = check.leaf_norms(grads)
            del grads, st
    finally:
        precise(True)
    dp = {n: float((v - p0[n]).double().norm()) for n, v in rs["params"].items()}
    return RefSteps(losses=losses, g=g, dp=dp, params=rs["params"], stats=acc)


def _barrier(ctrl) -> None:
    """Every rank's host here (a broadcast over the host's Gloo group)."""
    import torch.distributed as dist

    dist.broadcast(torch.zeros(1, dtype=torch.int32), src=0, group=ctrl)


def _body(rank: int, ranks: int, init: str, cell, seed: int, seconds: float, trace: bool, t_start: float,
          last):
    """One rank's run; rank 0 returns the run's Outcome, the others None.
    last: shared memory holding the window's last step, 0 until rank 0
    has set it."""
    import torch.distributed as dist

    from street_gaussians_torch.parallel import comm

    dev = rank_device(rank)
    group = comm.init_group(rank=rank, world_size=ranks, init_method=init, device=dev)
    ctrl = dist.new_group(backend="gloo")
    tr = cell.traffic
    S = BatchSetup(cell, seed, dev, group, trace)
    start_it, cycle = S.start_it, S.cycle
    state, checked, prog_losses, prog_g, prog_dp = S.checked_steps(tr["checked_steps"])
    checked_bad = int(S.bad)
    dens = S.checked_densify(state, seed) if rank == 0 and S.densify_at_cycle_end() else None
    program.clone_state(S.snapshot)
    sync(dev)
    _barrier(ctrl)  # every rank set up
    setup_s = time.perf_counter() - t_start

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
        if rank == 0 and not last.value and clock + time.perf_counter() - t0 >= seconds:
            last.value = steps + STOP_MARGIN
        if steps == last.value:
            break
    sync(dev)
    clock += time.perf_counter() - t0
    failed = torch.tensor([float(int(S.bad))], dtype=torch.float64)  # the same on every rank: overflow is summed
    dist.all_reduce(failed, op=dist.ReduceOp.MAX, group=ctrl)
    peak = torch.tensor([float(torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0)],
                        dtype=torch.float64)
    dist.all_reduce(peak, op=dist.ReduceOp.MAX, group=ctrl)

    layer_ctx, device_extra = None, None
    if trace:
        n = tr["profiled_steps"]
        if state.step + n >= start_it + cycle:
            state = program.clone_state(S.snapshot)

        def stretch():
            nonlocal state
            for _ in range(n):
                state = S.one(state)

        if rank == 0:
            path = _profile(dev, stretch)
            sm = _summary(path)
            from benchmark.harness import trace as trc

            layer_ctx = {"kind": "train", "steps": n, "unprofiled_s": clock / steps,
                         "densify_s": S.densify_s / steps, "trace": sm, "work": {}}
            device_extra = {"busy_s": sm["busy_ms"] / 1e3, "window_s": sm["window_ms"] / 1e3,
                            "breakdown": {"device_ops": trc.top_ops(sm["dev"]),
                                          "idle_gaps": trc.idle_gaps(sm["events"], sm["dev"], sm["lo_us"],
                                                                     sm["hi_us"])}}
            os.unlink(path)
        else:
            stretch()
            sync(dev)
    _barrier(ctrl)  # every rank done with the card's work
    scene, cfg = S.scene, S.cfg
    truths_used = {i: S.truths[i] for views, _, _ in checked for i in views}
    del state, S
    comm.close_group()
    if rank != 0:
        return None
    if dev.type == "cuda":
        torch.cuda.empty_cache()
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
    return Outcome(attempted=steps, failed=int(failed.item()), setup_s=setup_s, window_s=clock,
                   e2e={"train_step_ms": 1e3 * clock / steps}, numbers=numbers, limits=limits,
                   peak_bytes=int(peak.item()), layer_ctx=layer_ctx, device=device_extra)


def run(cell, seed: int, seconds: float, trace: bool, dev, t_start: float) -> Outcome:
    """Rank 0 here, the other ranks in processes of their own."""
    import torch.multiprocessing as mp

    ranks = int(cell.traffic["ranks"])
    if dev.type == "cuda":
        program.build_kernels()  # once, before the ranks start
    fd, path = tempfile.mkstemp(prefix="bench_group_")
    os.close(fd)
    os.unlink(path)
    init = "file://" + path
    ctx = mp.get_context("spawn")
    last = ctx.RawValue("q", 0)
    procs: List = [ctx.Process(target=_body, args=(r, ranks, init, cell, seed, seconds, trace, t_start, last),
                               daemon=True) for r in range(1, ranks)]
    for p in procs:
        p.start()
    try:
        out = _body(0, ranks, init, cell, seed, seconds, trace, t_start, last)
    finally:
        for p in procs:
            p.join(timeout=TIMEOUT_S)
            if p.is_alive():
                p.kill()
        if os.path.exists(path):
            os.unlink(path)
    bad = [p.exitcode for p in procs if p.exitcode != 0]
    if bad:
        raise RuntimeError(f"camera ranks exited with {bad}")
    return out

