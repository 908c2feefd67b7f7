"""Rank bodies of the port's parallel tests (tests/test_torch_parallel_*.py).

`Ranks` starts the ranks with torch.multiprocessing (spawn start method)
once per test module, which computes its JAX references meanwhile: each rank forms a Gloo group on the CPU
(in hosts of local_world_size ranks, when given) through a
file under the test's directory (no port is fixed, so parallel test
workers cannot collide), runs the named cases on the inputs the module
saved, and saves what it got; the module compares. This file imports
neither JAX nor the JAX package: the ranks run the port alone.
"""

import os
import time

import numpy as np
import torch

from street_gaussians_torch import runner
from street_gaussians_torch.parallel import comm, dp, gauss, tiles
from street_gaussians_torch.train_lib import flatten_params, init_train_state, make_densify_fn, make_reset_opacity_fn

TIMEOUT_S = 600


def _state_numpy(state):
    """A train state as flat {name: tensor} dicts, for comparing."""
    return {
        "params": {k: v.detach().clone() for k, v in flatten_params(state.params).items()},
        "mu": dict(state.adam.mu), "nu": dict(state.adam.nu), "count": dict(state.adam.count),
        "aux": {k: getattr(state.aux, k) for k in ("alive", "grad_accum", "denom", "max_radii")},
        "step": state.step,
    }


def case_band_render(inp, group):
    """make_row_sharded_render over the band group."""
    render = tiles.make_row_sharded_render(inp["table"], inp["pose"], inp["opts"], group.size, group=group)
    with torch.no_grad():
        out = render(inp["params"], inp["aux"], inp["frame"])
    return {k: v.clone() for k, v in out.items()}


def case_band_grads(inp, group):
    """Gradients of sum(rgb * dl) through the band group's render: loss /
    D, the gather's reduce-scatter and one sum over the group (the
    calibration of parallel/tiles.py)."""
    render = tiles.make_row_sharded_render(inp["table"], inp["pose"], inp["opts"], group.size, group=group)
    flat = {k: v.detach().requires_grad_(True) for k, v in flatten_params(inp["params"]).items()}
    from street_gaussians_torch.train_lib import unflatten_params

    out = render(unflatten_params(flat, inp["params"]), inp["aux"], inp["frame"])
    loss = (out["rgb"] * inp["dl"]).sum()
    grads = torch.autograd.grad(loss / group.size, list(flat.values()), allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g for g, x in zip(grads, flat.values())]
    return {"loss": loss.detach(), "grads": dict(zip(flat, group.all_reduce(grads, "sum")))}


def case_band_steps(inp, group):
    """make_tile_sharded_train_step over the band group, one step a draw."""
    step_fn = tiles.make_tile_sharded_train_step(inp["cfg"], inp["table"], inp["pose"], inp["train_opts"],
                                                 group.size, group=group)
    state, states, scalars = inp["state"], [], []
    for draws in inp["draws"]:
        state, sc = step_fn(state, inp["frame"], inp["gt"], draws=draws)
        states.append(_state_numpy(state))
        scalars.append(sc)
    return {"states": states, "scalars": scalars}


def _camera_step(inp, group, tile_shards):
    step_fn = dp.make_data_parallel_train_step(inp["cfg"], inp["table"], inp["pose"], inp["train_opts"], group,
                                               tile_shards=tile_shards)
    r = group.rank
    state, sc = step_fn(inp["state"], inp["frames"][r], inp["gts"][r], draws=inp["camera_draws"][r])
    return {"state": _state_numpy(state), "scalars": sc}


def case_camera_step(inp, group):
    """make_data_parallel_train_step: one camera a rank."""
    return _camera_step(inp, group, 1)


def case_camera_band_step(inp, group):
    """Data x tile: one camera a rank, in two bands in turn."""
    return _camera_step(inp, group, 2)


def _training(cfg, **kw):
    """runner.training with numpy's global generator seeded as
    tests/test_torch_runner.py seeds it (the scene build's actor colours)."""
    np.random.seed(0)
    final = runner.training(cfg, progress=False, **kw)
    return {k: final[k] for k in ("param_checksum", "ema_loss", "num_alive", "start_iteration", "host_views")
            if k in final}


def case_runner(inp, group):
    """runner.training at train.batch_size 2 under the group."""
    return _training(inp["runner_cfgs"]["batch"], group=group)


def case_runner_bands(inp, group):
    """runner.training at train.tile_shards 2 under the group: one band a
    rank."""
    return _training(inp["runner_cfgs"]["bands"], group=group)


def case_runner_alone(inp, group):
    """runner.training without the group, one configuration a rank (the
    group's ranks as two independent processes)."""
    return _training(inp["runner_cfgs"]["alone"][group.rank], device="cpu")


# ---- Gaussian sharding (tests/test_torch_parallel_gauss.py): four ranks,
# two hosts of two (local_world_size 2); the gauss cases run on the two
# gauss groups of Group.split(2), ranks {0, 1} and {2, 3}, alike.


def _local_rows(state):
    """The rows of each per-row leaf this rank holds."""
    leaves, _ = gauss.row_leaves(state)
    return sorted({int(x.shape[0]) for x in leaves})


def case_gauss_render(inp, group):
    """make_gauss_sharded_render over a gauss group of 2 (each rank its
    block of the rows), the whole frame, and in 2 bands in turn a rank
    (gausstile 2x2); the actors alone."""
    gg, _ = group.split(2)
    st = gauss.shard_train_state(init_train_state(inp["params"], inp["aux"]), gg.rank, 2)
    out = {"rows": _local_rows(st)}
    for name, T, mask in (("gauss", 1, None), ("gausstile", 2, None), ("object", 1, inp["obj_mask"])):
        render = gauss.make_gauss_sharded_render(inp["table"], inp["pose"], inp["opts"], 2, group=gg,
                                                 tile_shards=T, include_mask=mask)
        with torch.no_grad():
            out[name] = {k: v.clone() for k, v in render(st.params, st.aux, inp["frame"]).items()}
    return out


def case_gauss_steps(inp, group):
    """make_gauss_sharded_train_step over a gauss group of 2, the whole
    frame and in 2 bands in turn (gauss x tile), one step a draw of the
    JAX single step's; the states gathered after each step, the rows
    and bytes of row state each rank holds."""
    gg, _ = group.split(2)
    res = {}
    for T in (1, 2):
        step_fn = gauss.make_gauss_sharded_train_step(inp["cfg"], inp["table"], inp["pose"], inp["train_opts"], 2,
                                                      group=gg, tile_shards=T)
        state = gauss.shard_train_state(inp["state"], gg.rank, 2)
        out = {"rows": _local_rows(state), "bytes": gauss.row_state_bytes(state), "states": [], "scalars": []}
        for draws in inp["draws"]:
            state, sc = step_fn(state, inp["frame"], inp["gt"], draws=draws)
            out["states"].append(_state_numpy(gauss.gather_train_state(state, step_fn.shards)))
            out["scalars"].append(sc)
        out["rows_after"] = _local_rows(state)
        res[T] = out
    return res


def case_gauss_camera(inp, group):
    """Gauss x camera: the [2, 2] mesh of Group.split(2), camera b on
    the gauss group b; beside it the camera-parallel step over the same
    data group on the whole state."""
    gg, dg = group.split(2)
    b = dg.rank
    step_fn = gauss.make_gauss_sharded_train_step(inp["cfg"], inp["table"], inp["pose"], inp["train_opts"], 2,
                                                  group=gg, data_group=dg)
    state, sc = step_fn(gauss.shard_train_state(inp["state"], gg.rank, 2), inp["frames"][b], inp["gts"][b],
                        draws=inp["camera_draws"][b])
    dp_step = dp.make_data_parallel_train_step(inp["cfg"], inp["table"], inp["pose"], inp["train_opts"], dg)
    s2, sc2 = dp_step(inp["state"], inp["frames"][b], inp["gts"][b], draws=inp["camera_draws"][b])
    return {"state": _state_numpy(gauss.gather_train_state(state, step_fn.shards)), "scalars": sc,
            "dp_state": _state_numpy(s2), "dp_scalars": sc2}


def case_gauss_densify(inp, group):
    """Densify and the opacity reset on a row-sharded state (gathered,
    run, sharded again: gauss.whole_state) against the same on the whole
    state, after one sharded step (the statistics collected)."""
    gg, _ = group.split(2)
    step_fn = gauss.make_gauss_sharded_train_step(inp["cfg"], inp["table"], inp["pose"], inp["train_opts"], 2,
                                                  group=gg)
    shards = step_fn.shards
    state, _ = step_fn(gauss.shard_train_state(inp["state"], gg.rank, 2), inp["frame"], inp["gt"],
                       draws=inp["draws"][0])
    densify = make_densify_fn(inp["densify_cfg"], inp["table"])
    reset = make_reset_opacity_fn()
    whole = gauss.gather_train_state(state, shards)
    want, diag = densify(whole, torch.Generator().manual_seed(5), True)
    got_s, diag2 = gauss.whole_state(densify, shards, state, torch.Generator().manual_seed(5), True)
    rows = _local_rows(got_s)
    got = gauss.gather_train_state(got_s, shards)
    want_r, got_r = reset(want), gauss.gather_train_state(gauss.whole_state(reset, shards, got_s), shards)
    return {"diag": {k: int(v) for k, v in diag.items()}, "diag_sharded": {k: int(v) for k, v in diag2.items()},
            "want": _state_numpy(want), "got": _state_numpy(got), "want_reset": _state_numpy(want_r),
            "got_reset": _state_numpy(got_r), "rows": rows}


def case_runner_hosts(inp, group):
    """Two hosts of one rank (ranks 0 and 2) train at train.multihost
    true, train.batch_size 2; beside them ranks 1 and 3 (one host) train
    camera-parallel at batch_size 2 on the same cameras."""
    hosts, cams = group.subgroup([0, 2]), group.subgroup([1, 3])
    if hosts is not None:
        return _training(inp["runner_cfgs"]["hosts"], group=hosts)
    return _training(inp["runner_cfgs"]["cameras"], group=cams)


def case_runner_gauss_hosts(inp, group):
    """The four ranks, two hosts of two: train.multihost true,
    batch_size 2, gauss_shards 2 (a gauss group a host, one camera a
    host)."""
    return _training(inp["runner_cfgs"]["gauss_hosts"], group=group)


def case_runner_gauss(inp, group):
    """train.gauss_shards 2 over ranks {0, 1}; gauss_shards 2 with
    tile_shards 2 over ranks {2, 3}."""
    a, b = group.subgroup([0, 1]), group.subgroup([2, 3])
    if a is not None:
        return _training(inp["runner_cfgs"]["gauss"], group=a)
    return _training(inp["runner_cfgs"]["gauss_tile"], group=b)


def case_runner_gauss_resume(inp, group):
    """Ranks {0, 1} resume the train.gauss_shards 2 run to its longer
    length (ranks 2 and 3 wait)."""
    a = group.subgroup([0, 1])
    return None if a is None else _training(inp["runner_cfgs"]["gauss_resume"], group=a)


CASES = {f.__name__[len("case_"):]: f for f in (case_band_render, case_band_grads, case_band_steps,
                                                 case_camera_step, case_camera_band_step, case_runner,
                                                 case_runner_bands, case_runner_alone, case_gauss_render,
                                                 case_gauss_steps, case_gauss_camera, case_gauss_densify,
                                                 case_runner_hosts, case_runner_gauss_hosts, case_runner_gauss,
                                                 case_runner_gauss_resume)}


def run(rank, world, workdir, cases, local_world_size=None):
    torch.set_num_threads(1)
    group = comm.init_group(rank, world, "file://" + os.path.join(workdir, "rendezvous"), device="cpu",
                            local_world_size=local_world_size)
    try:
        inp = torch.load(os.path.join(workdir, "input.pt"), weights_only=False)
        out = {}
        for name in cases:
            out[name] = CASES[name](inp, group)
        torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
    finally:
        comm.close_group()


class Ranks:
    """`world` ranks started on `cases` (spawn start method); the module
    computes its references while they run, and `results()` waits for
    them (a rank that fails raises here) and gives each rank's {case:
    result}."""

    def __init__(self, workdir: str, inputs: dict, cases, world: int = 2, local_world_size=None):
        os.makedirs(workdir, exist_ok=True)
        torch.save(inputs, os.path.join(workdir, "input.pt"))
        self.workdir, self.world, self._results = workdir, world, None
        self.ctx = torch.multiprocessing.spawn(run, args=(world, workdir, list(cases), local_world_size),
                                               nprocs=world, join=False)

    def results(self):
        if self._results is None:
            deadline = time.monotonic() + TIMEOUT_S
            while not self.ctx.join(timeout=max(deadline - time.monotonic(), 1.0)):
                if time.monotonic() > deadline:
                    self.close()
                    raise TimeoutError(f"the ranks did not finish in {TIMEOUT_S} s")
            self._results = [torch.load(os.path.join(self.workdir, f"rank{r}.pt"), weights_only=False)
                             for r in range(self.world)]
        return self._results

    def close(self):
        """Stop the ranks that still run (a module that failed early)."""
        for p in self.ctx.processes:
            if p.is_alive():
                p.terminate()
            p.join(timeout=30)
