"""The port's camera data parallel training (parallel/dp.py, and its form
of the JAX package's ('data', 'tile') mesh) against the JAX package's
make_data_parallel_train_step on the conftest's 8-device virtual CPU
mesh (Pallas in interpret mode); the runner's batched and banded
training (runner.training under a process group, train.tile_shards over
a band group and in turn).

The port's ranks are two spawned processes in a Gloo group on the CPU,
once for the module (tests/torch_parallel_workers.py), one camera each:
views 1 and 2 of the toy scene of tests/test_torch_parallel_tiles.py
(32x48, one actor flipped with probability 0.5, a random sky), with the
draws each JAX rank takes from fold_in(key, rank), from the step before
densify_until_iter (the statistics collected). The data x tile step (two
ranks, each camera in two bands in turn) is held to the same JAX step:
the JAX package's tests/test_tile_train.py:263-305 holds its ('data',
'tile') step to it.

Tolerances: tests/test_torch_parallel_tiles.py's (the loss and scalars
within rtol 1e-5; gradients and parameters by chip_smoke's grads_close
and params_close; counts equal); the two ranks' parameters, moments and
statistics bit-equal. The runner: rank 0 alone writes; the ranks end
bit-equal; train.tile_shards 2 against the same run in one band within
the tolerance of tests/test_torch_runner.py's log (rtol 1e-4: the bands
blend the same instances in another order of sums).
"""

import copy
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_workers as workers
from street_gaussians_torch import convert
from street_gaussians_torch import runner as trunner
from street_gaussians_torch.config import load_config as t_load_config
from street_gaussians_torch.parallel import comm
from street_gaussians_torch.parallel.dp import pop_batch
from street_gaussians_tpu import train_lib as jtrain
from street_gaussians_tpu.parallel import dp as jdp
from test_torch_parallel_tiles import FRAME, assert_scalars, assert_state_matches, cfgs, draws_of, ground_truth, toy
from test_torch_runner import draw_free_overrides, one_thread, read_log, write_sequence  # noqa: F401
from test_torch_train import numpy_tree, port_state

VIEWS = (FRAME, 2)
KEY = 11
RUN_ITERS = 10


@pytest.fixture(scope="module")
def camera_inputs():
    """Views 1 and 2 of the toy scene, their ground truth, the JAX state at
    the step before densify_until_iter and each JAX rank's draws."""
    s = toy(32)
    jcfg, tcfg = cfgs()
    jgts = [ground_truth(s, seed, v) for seed, v in enumerate(VIEWS)]
    start = jcfg.optim.densify_until_iter - 1
    state0 = dataclasses.replace(jtrain.init_train_state(s.jparams, s.jscene.aux), step=jnp.asarray(start, jnp.int32))
    key = jax.random.PRNGKey(KEY)
    H, W = s.jscene.frames[FRAME].cam.H, s.jscene.frames[FRAME].cam.W
    return dict(s=s, jcfg=jcfg, tcfg=tcfg, jgts=jgts, state0=state0, key=key,
                draws=[draws_of(key, s.jtable, s.jscene.aux, H, W, fold=d) for d in range(2)])


@pytest.fixture(scope="module", autouse=True)
def camera_group(camera_inputs, tmp_path_factory):
    """The port's two ranks, started first (they run while the module
    computes the JAX reference): the camera steps, and the runner at
    train.batch_size 2 and at train.tile_shards 2 under the group, and
    alone at tile_shards 1 (rank 0) and 2 in turn (rank 1)."""
    c = camera_inputs
    s = c["s"]
    tmp = tmp_path_factory.mktemp("camera_group")
    root = str(tmp / "seq")
    write_sequence(root, num_frames=2)
    cfg = lambda name, *extra: t_load_config(None, run_overrides(root, str(tmp / name), *extra))  # noqa: E731
    runner_cfgs = dict(batch=cfg("batch", "train.batch_size", "2"), bands=cfg("bands", "train.tile_shards", "2"),
                       alone=[cfg("alone1", "train.tile_shards", "1"), cfg("alone2", "train.tile_shards", "2")])
    inputs = dict(
        table=s.table, pose=s.pose, cfg=c["tcfg"], train_opts=dataclasses.replace(s.opts, mode="train"),
        state=port_state(c["state0"]), frames=[s.frames[v] for v in VIEWS],
        gts=[convert.ground_truth_from_numpy(numpy_tree(g), "cpu") for g in c["jgts"]],
        camera_draws=c["draws"], runner_cfgs=runner_cfgs,
    )
    ranks = workers.Ranks(str(tmp / "ranks"), inputs,
                          ("camera_step", "camera_band_step", "runner", "runner_bands", "runner_alone"))
    ranks.runner_cfgs = runner_cfgs
    yield ranks
    ranks.close()


@pytest.fixture(scope="module")
def jax_dp(camera_inputs):
    """JAX's camera-parallel step on the two views. It is also the
    reference of the port's data x tile step: the JAX package's
    tests/test_tile_train.py:263-305 holds its ('data', 'tile') step to
    this one."""
    c = camera_inputs
    s = c["s"]
    jopts = dataclasses.replace(s.jopts, mode="train")
    dp_fn = jdp.make_data_parallel_train_step(c["jcfg"], s.jtable, s.jscene.pose_data, jopts, jdp.make_mesh(2))
    frames_b = jdp.stack_frames([s.jscene.frames[v] for v in VIEWS])
    return dp_fn(copy.deepcopy(c["state0"]), frames_b, jdp.stack_gts(c["jgts"]), c["key"])


def run_overrides(root, model_path, *extra):
    """tests/test_torch_runner.py's draw-free configuration, cut to
    RUN_ITERS iterations, one checkpoint at the end."""
    return [*draw_free_overrides(root, model_path, RUN_ITERS), "train.test_iterations", f"[{RUN_ITERS}]",
            "train.save_iterations", f"[{RUN_ITERS}]", "train.checkpoint_iterations", f"[{RUN_ITERS}]", *extra]


def assert_ranks_equal(ranks, case):
    a, b = (r[case]["state"] for r in ranks)
    for part in ("params", "mu", "nu", "count", "aux"):
        for k in a[part]:
            assert torch.equal(a[part][k], b[part][k]), (case, part, k)


@pytest.mark.parametrize("case", ["camera_step", "camera_band_step"])
def test_camera_parallel_step_matches_jax(camera_group, camera_inputs, jax_dp, case):
    """tests/test_multichip.py:28-90 and tests/test_tile_train.py:263-305:
    two cameras, one a rank (camera_band_step: each in two bands in turn),
    the gradients averaged and the statistics summed over the ranks; the
    ranks bit-equal."""
    js, jsc = jax_dp
    ranks = camera_group.results()
    assert_ranks_equal(ranks, case)
    for r in ranks:
        assert_scalars(r[case]["scalars"], {k: np.asarray(v) for k, v in jsc.items()})
    assert_state_matches(ranks[0][case]["state"], js, js, camera_inputs["tcfg"], 1)


def test_batched_runner_under_a_group(camera_group):
    """runner.training at train.batch_size 2 over the 2-rank group: the
    ranks end bit-equal, rank 0 alone wrote the log (one record at 10 and
    the eval) and the checkpoint."""
    a, b = (r["runner"] for r in camera_group.results())
    assert a["param_checksum"] == b["param_checksum"] and np.isfinite(a["ema_loss"])
    cfg = camera_group.runner_cfgs["batch"]
    recs = read_log(cfg)
    assert [r["iteration"] for r in recs] == [RUN_ITERS, RUN_ITERS] and "train_psnr" in recs[1]
    assert os.path.isdir(os.path.join(cfg.trained_model_dir, f"iteration_{RUN_ITERS}"))


def test_tile_shards_through_the_runner(camera_group):
    """train.tile_shards 2 over the band group and in turn in one process
    against the same run in one band: param_checksum, the log's losses at
    10 and the eval's PSNR of the final state; the band group's ranks
    bit-equal. Each run seeds numpy's generator before its scene build
    (tests/test_torch_runner.py)."""
    ranks = camera_group.results()
    a, b = (r["runner_bands"] for r in ranks)
    assert a["param_checksum"] == b["param_checksum"]
    one, in_turn = ranks[0]["runner_alone"], ranks[1]["runner_alone"]
    cfgs_ = camera_group.runner_cfgs
    logs = {k: read_log(c) for k, c in (("one", cfgs_["alone"][0]), ("in_turn", cfgs_["alone"][1]),
                                         ("group", cfgs_["bands"]))}
    for final, name in ((in_turn, "in_turn"), (a, "group")):
        np.testing.assert_allclose(final["param_checksum"], one["param_checksum"], rtol=1e-5)
        assert len(logs[name]) == len(logs["one"]) == 2
        for w, g in zip(logs["one"], logs[name]):
            assert set(w) == set(g)
            for k in w:
                np.testing.assert_allclose(g[k], w[k], rtol=1e-4, atol=1e-6, err_msg=f"{name} {k}")


def test_runner_refuses_groups_it_cannot_use(tmp_path):
    """A group must be the batch or the band group; batch_size beyond the
    ranks trains one camera a step and says so (JAX's runner.py:476-481)."""
    root = str(tmp_path / "seq")
    write_sequence(root, num_frames=2)
    group = comm.Group(rank=0, size=2, backend="gloo", device=torch.device("cpu"))
    cases = ((group, ["train.batch_size", "4"], "needs train.batch_size 2 or train.tile_shards 2"),
             (group, ["train.batch_size", "1"], "needs train.batch_size 2 or train.tile_shards 2"),
             (group, ["train.tile_shards", "4"], "tile_shards=4 over 2 ranks"),
             (None, ["train.batch_size", "2", "train.tile_shards", "2"], "needs 2 ranks, have 1"))
    for g, extra, match in cases:
        cfg = t_load_config(None, run_overrides(root, str(tmp_path / "out"), *extra))
        with pytest.raises(RuntimeError, match=match):
            trunner._Plan(cfg, g)
    for g, extra, batch, bands in ((None, ["train.batch_size", "2"], 1, None),
                                   (group, ["train.batch_size", "2", "train.tile_shards", "2"], 2, None),
                                   (group, ["train.tile_shards", "2"], 1, group)):
        plan = trunner._Plan(t_load_config(None, run_overrides(root, str(tmp_path / "out"), *extra)), g)
        assert (plan.batch, plan.band_group, plan.group) == (batch, bands, g)


def test_pop_batch_follows_the_jax_runner():
    """runner.py:787-813: the batch-mates of the last view's (H, W), the
    others back on the stack in order, cycled when short."""

    class V:
        def __init__(self, name, H):
            self.name, self.H, self.W = name, H, 8

    stack = [V("a", 4), V("b", 6), V("c", 4), V("d", 6), V("e", 4)]
    assert [v.name for v in pop_batch(stack, 3)] == ["e", "c", "a"]
    assert [v.name for v in stack] == ["d", "b"]
    assert [v.name for v in pop_batch(stack, 3)] == ["b", "d", "b"]
    assert stack == []
