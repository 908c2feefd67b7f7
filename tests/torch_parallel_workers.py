"""Rank bodies of the port's parallel tests (tests/test_torch_parallel_*.py).

`Ranks` starts the ranks with torch.multiprocessing (spawn start method)
once per test module, which computes its JAX references meanwhile: each rank forms a Gloo group on the CPU through a
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
from street_gaussians_torch.parallel import comm, dp, tiles
from street_gaussians_torch.train_lib import flatten_params

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
    return {k: final[k] for k in ("param_checksum", "ema_loss")}


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


CASES = {f.__name__[len("case_"):]: f for f in (case_band_render, case_band_grads, case_band_steps,
                                                 case_camera_step, case_camera_band_step, case_runner,
                                                 case_runner_bands, case_runner_alone)}


def run(rank, world, workdir, cases):
    torch.set_num_threads(1)
    group = comm.init_group(rank, world, "file://" + os.path.join(workdir, "rendezvous"), device="cpu")
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

    def __init__(self, workdir: str, inputs: dict, cases, world: int = 2):
        os.makedirs(workdir, exist_ok=True)
        torch.save(inputs, os.path.join(workdir, "input.pt"))
        self.workdir, self.world, self._results = workdir, world, None
        self.ctx = torch.multiprocessing.spawn(run, args=(world, workdir, list(cases)), nprocs=world, join=False)

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
