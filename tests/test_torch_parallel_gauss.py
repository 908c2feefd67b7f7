"""The port's Gaussian-sharded modes (parallel/gauss.py: the row-sharded
render and train step, gauss x tile and gauss x camera; parallel/comm.py:
hosts and Group.split; parallel/dp.node_views; the runner's
train.gauss_shards, train.multihost and render.parallel gauss=N /
gausstile=GxT) against the JAX package's on the conftest's 8-device
virtual CPU mesh, with the Pallas kernels in interpret mode.

Scene: tests/test_torch_parallel_tiles.py's toy (32x48, 896 rows, one
actor flipped with probability 0.5 in train mode, a random 32-texel
sky). The port's ranks are four spawned processes in a Gloo group on
the CPU, two hosts of two ranks (local_world_size 2), once for the
module (tests/torch_parallel_workers.py): the gauss cases run on the two
gauss groups of Group.split(2), ranks {0, 1} and {2, 3}; the rows in
turn run in this process.

Tolerances, and why:
* renders: tests/test_gauss_shard.py's (rgb and acc 2e-5, depth 2e-4,
  radii 1e-4) against JAX's sharded and single renders; the integer
  outputs (num_instances, the overflow counters) equal; the joined
  screen of the blocks equals the whole table's bit for bit (so the
  binning lists and tile_start / tile_count are the whole screen's);
* train steps: against JAX's single step with its own draws injected
  (the port's sharded step takes the whole table's flip; JAX draws its
  sharded flips per shard, ROADMAP.md's reference-side facts) by the
  port's tolerances against JAX (tests/test_torch_parallel_tiles.py's
  assert_scalars: rtol 1e-5, atol 1e-6; chip_smoke's grads_close /
  params_close), `denom` equal; against the port's own single step on
  the same draws by tests/test_gauss_train.py:76-182's model of a
  sharded step against the single one (the loss within rtol 1e-5,
  _compare_rows on the Gaussian leaves and their moments, `denom`
  equal). The port's single step itself is 1.2e-5 off JAX's loss on
  this scene, so the model's rtol 1e-5 reads the sharding, not the
  port;
* the runner: the ranks of one run bit-equal; runs against each other
  at rtol 1e-5 on param_checksum (the actors' gradients summed in
  another order) and the log at tests/test_torch_parallel_dp.py's
  rtol 1e-4.
"""

import copy
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import torch_parallel_workers as workers
from street_gaussians_torch import convert
from street_gaussians_torch import runner as trunner
from street_gaussians_torch import train_lib as ttrain
from street_gaussians_torch.config import load_config as t_load_config
from street_gaussians_torch.models import renderer as trend
from street_gaussians_torch.parallel import comm, gauss
from street_gaussians_torch.parallel.dp import node_views
from street_gaussians_tpu import train_lib as jtrain
from street_gaussians_tpu.models import renderer as jrend
from street_gaussians_tpu.parallel import dp as jdp
from street_gaussians_tpu.parallel import gauss as jgauss
from test_gauss_train import _compare_rows
from test_torch_parallel_tiles import (
    FRAME,
    assert_scalars,
    assert_state_matches,
    cfgs,
    dict_numpy,
    draws_of,
    ground_truth,
    toy,
)
from test_torch_runner import draw_free_overrides, one_thread, read_log, small_sensors, write_sequence  # noqa: F401
from test_torch_train import jax_flat, numpy_tree, port_state

RENDER_TOL = {"rgb": 2e-5, "acc": 2e-5, "depth": 2e-4, "radii": 1e-4}
INTS = ("num_instances", "overflow", "overflow_instance", "overflow_tile")
TRAIN_KEYS = (3, 4, 5)
VIEWS = (FRAME, 2)
RUN_ITERS = 10
RESUME_ITERS = 15
CASES = ("gauss_render", "gauss_steps", "gauss_camera", "gauss_densify", "runner_hosts", "runner_gauss_hosts",
         "runner_gauss", "runner_gauss_resume")


@pytest.fixture(scope="module")
def s():
    return toy(32)


@pytest.fixture(scope="module")
def inputs(s):
    """Both packages' configs, the ground truth of FRAME and of the two
    camera views, the JAX state at the step before densify_until_iter
    (the first step collects the statistics, the second renders the
    actors alone for the object-opacity loss) and the draws: the JAX
    single step's of keys TRAIN_KEYS, each JAX camera rank's of key 11."""
    jcfg, tcfg = cfgs()
    f = s.jscene.frames[FRAME]
    H, W = f.cam.H, f.cam.W
    start = jcfg.optim.densify_until_iter - 1
    state0 = dataclasses.replace(jtrain.init_train_state(s.jparams, s.jscene.aux), step=jnp.asarray(start, jnp.int32))
    jgts = [ground_truth(s, seed, v) for seed, v in enumerate(VIEWS)]
    key = jax.random.PRNGKey(11)
    return dict(jcfg=jcfg, tcfg=tcfg, state0=state0, jgt=jgts[0], jgts=jgts, key=key,
                gts=[convert.ground_truth_from_numpy(numpy_tree(g), "cpu") for g in jgts],
                draws=[draws_of(jax.random.PRNGKey(k), s.jtable, s.jscene.aux, H, W) for k in TRAIN_KEYS],
                camera_draws=[draws_of(key, s.jtable, s.jscene.aux, H, W, fold=d) for d in range(2)])


def run_overrides(root, model_path, iterations, *extra):
    """tests/test_torch_runner.py's draw-free configuration, one eval
    and one checkpoint at RUN_ITERS."""
    return [*draw_free_overrides(root, model_path, iterations), "train.test_iterations", f"[{RUN_ITERS}]",
            "train.save_iterations", f"[{RUN_ITERS}]", "train.checkpoint_iterations", f"[{RUN_ITERS}]", *extra]


@pytest.fixture(scope="module", autouse=True)
def ranks(s, inputs, tmp_path_factory):
    """The four ranks, started first: they run while the module computes
    the JAX references."""
    c = inputs
    tmp = tmp_path_factory.mktemp("gauss_ranks")
    root = str(tmp / "seq")
    write_sequence(root, num_frames=2)

    def cfg(name, iterations, *extra):
        return t_load_config(None, run_overrides(root, str(tmp / name), iterations, *extra))

    runner_cfgs = dict(
        hosts=cfg("hosts", RUN_ITERS, "train.batch_size", "2", "train.multihost", "true"),
        cameras=cfg("cameras", RUN_ITERS, "train.batch_size", "2"),
        gauss_hosts=cfg("gauss_hosts", RUN_ITERS, "train.batch_size", "2", "train.gauss_shards", "2",
                        "train.multihost", "true"),
        gauss=cfg("gauss", RUN_ITERS, "train.gauss_shards", "2"),
        gauss_tile=cfg("gauss_tile", RUN_ITERS, "train.gauss_shards", "2", "train.tile_shards", "2"),
        gauss_resume=cfg("gauss", RESUME_ITERS, "train.gauss_shards", "2"),
        one=cfg("one", RUN_ITERS),
    )
    runner_cfgs["resume_one"] = cfg("resume_one", RESUME_ITERS)
    densify_cfg = copy.deepcopy(c["tcfg"])
    densify_cfg.optim.densify_grad_threshold = 1e-7  # some rows clone and split
    inp = dict(
        table=s.table, pose=s.pose, params=s.params, aux=s.aux, frame=s.frames[FRAME], opts=s.opts,
        obj_mask=torch.as_tensor(trend.render_object_mask(s.table)), cfg=c["tcfg"], densify_cfg=densify_cfg,
        train_opts=dataclasses.replace(s.opts, mode="train"), state=port_state(c["state0"]), gt=c["gts"][0],
        draws=c["draws"], frames=[s.frames[v] for v in VIEWS], gts=c["gts"], camera_draws=c["camera_draws"],
        runner_cfgs=runner_cfgs,
    )
    r = workers.Ranks(str(tmp / "ranks"), inp, CASES, world=4, local_world_size=2)
    r.runner_cfgs = runner_cfgs
    yield r
    r.close()


@pytest.fixture(scope="module")
def rank_results(ranks, jax_renders, jax_steps, jax_dp, one_run):
    """The ranks' results, waited for once this process has computed its
    references (they run meanwhile)."""
    return ranks.results()


@pytest.fixture(scope="module")
def jax_renders(s):
    """JAX's single render of FRAME, its gauss-sharded renders at G = 2
    and 4, its ('gauss', 'tile') 2x2 render, and the actors alone, single
    and sharded at G = 4."""
    f = s.jscene.frames[FRAME]
    obj = jrend.render_object_mask(s.jtable)
    single = lambda mask=None: dict_numpy(jrend.render_frame(  # noqa: E731
        s.jparams, s.jscene.aux, s.jtable, s.jscene.pose_data, f, step=jnp.asarray(10**9), opts=s.jopts,
        include_mask=mask))
    sharded = lambda mesh, **kw: dict_numpy(jgauss.make_gauss_sharded_render(  # noqa: E731
        s.jtable, s.jscene.pose_data, s.jopts, mesh, **kw)(s.jparams, s.jscene.aux, f))
    mesh2d = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("gauss", "tile"))
    return {"single": single(), "gauss2": sharded(jgauss.make_gauss_mesh(2)),
            "gauss4": sharded(jgauss.make_gauss_mesh(4)), "gausstile": sharded(mesh2d, tile_axis="tile"),
            "object_single": single(obj), "object4": sharded(jgauss.make_gauss_mesh(4), include_mask=obj)}


@pytest.fixture(scope="module")
def jax_steps(s, inputs):
    """JAX's single train step in train mode, one step a key of
    TRAIN_KEYS from the state at densify_until_iter - 1."""
    c = inputs
    step = jtrain.make_train_step(c["jcfg"], s.jtable, s.jscene.pose_data, dataclasses.replace(s.jopts, mode="train"),
                                  donate=False)
    states, scalars = [c["state0"]], []
    for k in TRAIN_KEYS:
        st, sc = step(states[-1], s.jscene.frames[FRAME], c["jgt"], jax.random.PRNGKey(k))
        states.append(st)
        scalars.append(dict_numpy(sc))
    return states, scalars


def assert_render(got, want, what, tol=RENDER_TOL):
    for k, atol in tol.items():
        np.testing.assert_allclose(got[k].detach().numpy(), want[k], rtol=0, atol=atol, err_msg=f"{what} {k}")
    for k in INTS:
        assert int(got[k]) == int(want[k]), (what, k)


# ---------------------------------------------------------------- renders


@pytest.mark.parametrize("where", ["ranks_G2", "in_turn_G4"])
def test_gauss_render_matches_jax(s, jax_renders, rank_results, where):
    """tests/test_gauss_shard.py:25-53: the row-sharded render against
    JAX's at the same G and its single render; the radii and integer
    outputs equal the port's own whole render."""
    if where == "ranks_G2":
        outs, want = [r["gauss_render"]["gauss"] for r in rank_results], jax_renders["gauss2"]
    else:
        render = gauss.make_gauss_sharded_render(s.table, s.pose, s.opts, 4)
        with torch.no_grad():
            outs, want = [render(s.params, s.aux, s.frames[FRAME])], jax_renders["gauss4"]
    with torch.no_grad():
        whole = trend.render_frame(s.params, s.aux, s.table, s.pose, s.frames[FRAME], 10**9, opts=s.opts)
    for i, got in enumerate(outs):
        assert_render(got, want, f"{where} {i}: against JAX's sharded render")
        assert_render(got, jax_renders["single"], f"{where} {i}: against JAX's single render")
        assert torch.equal(got["radii"], whole["radii"]) and int(got["num_instances"]) > 0


def test_joined_screen_is_the_whole_tables(s):
    """Four blocks composed in turn and joined: every screen field and the
    extras (normals, semantics) equal screen_space of the whole table,
    with the flip and the view-space offsets of a train render."""
    opts = dataclasses.replace(s.opts, mode="train", render_normal=True, use_semantic=True)
    C = s.table.capacity
    flip = torch.rand(C, generator=torch.Generator().manual_seed(0)) < 0.5
    m2d = torch.zeros((C, 2))
    shards = gauss.Shards(C, 4)
    with torch.no_grad():
        got = gauss.screen_rows(s.params, s.aux, s.table, s.pose, s.frames[FRAME], 10**9, opts, shards, flip=flip,
                                mean2d_offset=m2d)
        want = trend.screen_space(s.params, s.aux, s.table, s.pose, s.frames[FRAME], 10**9, opts, flip=flip,
                                  mean2d_offset=m2d)
    for name, g, w in zip(want[0]._fields, got[0], want[0]):
        assert torch.equal(g, w), name
    for k in ("normals", "semantic"):
        assert torch.equal(got[1][k], want[1][k]), k


@pytest.mark.parametrize("where", ["ranks", "in_turn"])
def test_gausstile_render_matches_jax(s, jax_renders, rank_results, where):
    """tests/test_gauss_shard.py:93-117: G = 2 row blocks, each process's
    joined screen in 2 tile bands in turn, against JAX's 2x2 mesh."""
    if where == "ranks":
        outs = [r["gauss_render"]["gausstile"] for r in rank_results]
    else:
        render = gauss.make_gauss_sharded_render(s.table, s.pose, s.opts, 2, tile_shards=2)
        with torch.no_grad():
            outs = [render(s.params, s.aux, s.frames[FRAME])]
    for i, got in enumerate(outs):
        assert_render(got, jax_renders["gausstile"], f"gausstile {where} {i}")


@pytest.mark.parametrize("where", ["ranks_G2", "in_turn_G4"])
def test_object_subset_render_matches_jax(s, jax_renders, rank_results, where):
    """tests/test_gauss_shard.py:120-149: the actors alone through the
    row-sharded render."""
    if where == "ranks_G2":
        outs = [r["gauss_render"]["object"] for r in rank_results]
    else:
        render = gauss.make_gauss_sharded_render(s.table, s.pose, s.opts, 4,
                                                 include_mask=trend.render_object_mask(s.table))
        with torch.no_grad():
            outs = [render(s.params, s.aux, s.frames[FRAME])]
    for i, got in enumerate(outs):
        assert_render(got, jax_renders["object4"], f"object {where} {i}: against JAX's sharded render")
        assert_render(got, jax_renders["object_single"], f"object {where} {i}: against JAX's single render")
        assert float(got["acc"].max()) > 0


# ---------------------------------------------------------------- train steps


def assert_step(got_state, got_scalars, single, js, js1, jsc, cfg, steps):
    """A gathered port state against JAX's single step's (js, after
    `steps` steps; js1 after the first) by the port's tolerances against
    JAX (assert_scalars, assert_state_matches), and against the port's
    own single step on the same draws (single: its state and scalars) by
    tests/test_gauss_train.py:76-182's model of a sharded step against
    the single one: the loss within rtol 1e-5, the Gaussian leaves and
    their first moments by _compare_rows, denom equal."""
    assert_scalars(got_scalars, jsc)
    assert_state_matches(got_state, js, js1, cfg, steps)
    s_state, s_scalars, s0 = single
    np.testing.assert_allclose(float(got_scalars["loss"]), float(s_scalars["loss"]), rtol=1e-5)
    for k, v in got_state["params"].items():
        if k.startswith(ttrain.GAUSS):
            ref = s_state["params"][k].numpy()
            delta = ref - s0["params"][k].numpy()
            _compare_rows(k, v.numpy(), ref, delta)
            _compare_rows(f"mu {k}", got_state["mu"][k].numpy(), s_state["mu"][k].numpy(), delta, atol_step=1e-2)
    np.testing.assert_array_equal(got_state["aux"]["denom"].numpy(), s_state["aux"]["denom"].numpy())
    np.testing.assert_array_equal(got_state["aux"]["denom"].numpy(), np.asarray(js.aux.denom))


@pytest.fixture(scope="module")
def single_steps(s, inputs):
    """The port's single step on the same draws: the initial state, and
    each step's state and scalars."""
    c = inputs
    step_fn = ttrain.make_train_step(c["tcfg"], s.table, s.pose, dataclasses.replace(s.opts, mode="train"))
    state = port_state(c["state0"])
    s0, out = workers._state_numpy(state), []
    for d in c["draws"]:
        state, sc = step_fn(state, s.frames[FRAME], c["gts"][0], draws=d)
        out.append((workers._state_numpy(state), sc, s0))
    return out


@pytest.fixture(scope="module")
def in_turn_steps(s, inputs):
    """The port's sharded step at G = 2 in turn in this process."""
    c = inputs
    step_fn = gauss.make_gauss_sharded_train_step(c["tcfg"], s.table, s.pose,
                                                  dataclasses.replace(s.opts, mode="train"), 2)
    state, states, scalars = port_state(c["state0"]), [], []
    for d in c["draws"]:
        state, sc = step_fn(state, s.frames[FRAME], c["gts"][0], draws=d)
        states.append(workers._state_numpy(state))
        scalars.append(sc)
    return states, scalars


@pytest.mark.parametrize("where", ["ranks", "in_turn", "ranks_gauss_x_tile"])
def test_gauss_step_matches_jax_single_step(inputs, jax_steps, rank_results, in_turn_steps, single_steps, where):
    """tests/test_gauss_train.py:100-182 in train mode: the sharded step
    at G = 2 (over the gauss group, in turn, and with each rank's render
    in 2 tile bands in turn) against JAX's single step on its own draws,
    three steps (the second and third render the actors alone), the
    states after one and three; every rank of a group ends with the
    same whole state."""
    js, jsc = jax_steps
    if where == "in_turn":
        runs = [in_turn_steps]
    else:
        T = 2 if where == "ranks_gauss_x_tile" else 1
        runs = [(r["gauss_steps"][T]["states"], r["gauss_steps"][T]["scalars"]) for r in rank_results]
        for k, v in runs[0][0][-1]["params"].items():
            for other in runs[1:]:
                assert torch.equal(v, other[0][-1]["params"][k]), k
    for states, scalars in runs:
        assert "obj_acc_loss" not in scalars[0] and float(scalars[1]["obj_acc_loss"]) > 0
        for i in range(3):
            assert_scalars(scalars[i], jsc[i])
        # the states after one and three steps (tests/test_torch_parallel_tiles.py's)
        for i in (0, 2):
            assert_step(states[i], scalars[i], single_steps[i], js[i + 1], js[1], jsc[i], inputs["tcfg"], i + 1)


def test_gauss_state_is_split(s, rank_results):
    """tests/test_gauss_train.py:263-301: every per-row leaf (params, both
    Adam moments, the per-row counts, aux) holds C/2 rows on each rank,
    before and after the steps; the row state's bytes are half the
    whole's."""
    C = s.table.capacity
    whole = gauss.row_state_bytes(ttrain.init_train_state(s.params, s.aux))
    for r in rank_results:
        for T in (1, 2):
            got = r["gauss_steps"][T]
            assert got["rows"] == got["rows_after"] == [C // 2]
            assert got["bytes"] * 2 == whole
        assert r["gauss_render"]["rows"] == [C // 2]
        assert r["gauss_densify"]["rows"] == [C // 2]


@pytest.fixture(scope="module")
def jax_dp(s, inputs):
    c = inputs
    jopts = dataclasses.replace(s.jopts, mode="train")
    dp_fn = jdp.make_data_parallel_train_step(c["jcfg"], s.jtable, s.jscene.pose_data, jopts, jdp.make_mesh(2))
    frames_b = jdp.stack_frames([s.jscene.frames[v] for v in VIEWS])
    return dp_fn(copy.deepcopy(c["state0"]), frames_b, jdp.stack_gts(c["jgts"]), c["key"])


def test_gauss_camera_step_matches_camera_parallel(inputs, rank_results, jax_dp):
    """tests/test_gauss_train.py:210-260: gauss x camera over the four
    ranks (two cameras, a gauss group of two each) against JAX's
    camera-parallel step and the port's over the same data groups; all
    four ranks end with the same whole state."""
    js, jsc = jax_dp
    jsc = dict_numpy(jsc)
    first = rank_results[0]["gauss_camera"]
    for r in rank_results:
        got = r["gauss_camera"]
        for k, v in got["state"]["params"].items():
            assert torch.equal(v, first["state"]["params"][k]), k
        for state, sc in ((got["state"], got["scalars"]), (got["dp_state"], got["dp_scalars"])):
            assert_scalars(sc, jsc)
            assert_state_matches(state, js, js, inputs["tcfg"], 1)
        np.testing.assert_array_equal(got["state"]["aux"]["denom"].numpy(), got["dp_state"]["aux"]["denom"].numpy())


def test_densify_and_reset_on_a_sharded_state(rank_results):
    """runner.py:826-851: densify and the opacity reset on a row-sharded
    state (gathered, run with the same generator, sharded again) equal
    the same on the whole state, bit for bit."""
    for r in rank_results:
        got = r["gauss_densify"]
        assert got["diag"] == got["diag_sharded"]
        assert got["diag"]["points_clone"] + got["diag"]["points_split"] > 0
        for a, b in (("want", "got"), ("want_reset", "got_reset")):
            for part in ("params", "mu", "nu", "count", "aux"):
                for k, v in got[a][part].items():
                    assert torch.equal(v, got[b][part][k]), (a, part, k)


def test_gauss_refuses_what_jax_refuses(s, inputs):
    """gauss.py:335-358: the row-reducing regularizers, and data x gauss x
    tile."""
    opts = dataclasses.replace(s.opts, mode="train")
    for key in ("lambda_scale_flatten", "lambda_box_reg"):
        cfg = copy.deepcopy(inputs["tcfg"])
        cfg.optim[key] = 0.1
        with pytest.raises(NotImplementedError, match="lambda_scale_flatten / lambda_box_reg"):
            gauss.make_gauss_sharded_train_step(cfg, s.table, s.pose, opts, 2)
    cam_group = comm.Group(rank=0, size=2, backend="gloo", device=torch.device("cpu"))
    with pytest.raises(NotImplementedError, match="3D data x gauss x tile"):
        gauss.make_gauss_sharded_train_step(inputs["tcfg"], s.table, s.pose, opts, 2, data_group=cam_group,
                                            tile_shards=2)
    with pytest.raises(RuntimeError, match="capacity 896 must divide the 'gauss' axis size 3"):
        gauss.make_gauss_sharded_render(s.table, s.pose, s.opts, 3)


# ---------------------------------------------------------------- hosts and the runner


def test_node_views_follow_the_jax_runner():
    """runner.py:770-784: host i's slice stack[i::n], padded by wrapping
    to ceil(len / n); the slices are disjoint and cover the epoch."""
    stack = list("abcdefg")
    got = [node_views(stack, i, 3) for i in range(3)]
    assert got == [list("adg"), list("beb"), list("cfc")]
    assert stack == list("abcdefg")
    assert [node_views(list("abcd"), i, 2) for i in range(2)] == [list("ac"), list("bd")]


def test_group_hosts_and_split():
    """Hosts from local_world_size (host-major), and the [B, G] mesh's
    rows and columns (the split itself runs on the ranks)."""
    g = comm.Group(rank=5, size=8, backend="gloo", device=torch.device("cpu"), hosts=(0,) * 4 + (1,) * 4)
    assert (g.local_rank, g.local_size, g.node, g.nodes) == (1, 4, 1, 2)
    assert (comm.Group(rank=1, size=2, backend="gloo", device=torch.device("cpu")).nodes) == 1
    with pytest.raises(ValueError, match="host-major"):
        comm.Group(rank=0, size=4, backend="gloo", device=torch.device("cpu"), hosts=(0, 1, 0, 1))
    with pytest.raises(RuntimeError, match="8 ranks cannot form gauss groups of 3"):
        g.split(3)
    with pytest.raises(RuntimeError, match="multi-host gauss x DP needs 2 devices per process, have 4"):
        g.split(2, data_per_node=1)


def test_two_hosts_train_like_camera_parallel(ranks, rank_results):
    """Two hosts of one rank at train.multihost true and batch_size 2:
    each trains on its own slice of the epoch, both end with the same
    param_checksum, rank 0 alone wrote (one log record at RUN_ITERS and
    the eval, one checkpoint); the result equals the camera-parallel run
    of two ranks on one host fed the same cameras (ranks 1 and 3)."""
    h0, h1 = rank_results[0]["runner_hosts"], rank_results[2]["runner_hosts"]
    cam = rank_results[1]["runner_hosts"]
    assert cam == rank_results[3]["runner_hosts"]
    assert h0["param_checksum"] == h1["param_checksum"]
    assert (h0["host_views"]["host"], h1["host_views"]["host"]) == (0, 1)
    assert not set(h0["host_views"]["first_epoch"]) & set(h1["host_views"]["first_epoch"])
    np.testing.assert_allclose(h0["param_checksum"], cam["param_checksum"], rtol=1e-6)
    cfg = ranks.runner_cfgs["hosts"]
    recs = read_log(cfg)
    assert [r["iteration"] for r in recs] == [RUN_ITERS, RUN_ITERS] and "train_psnr" in recs[1]
    assert os.path.isdir(os.path.join(cfg.trained_model_dir, f"iteration_{RUN_ITERS}"))


def test_gauss_hosts_through_the_runner(rank_results):
    """The four ranks as two hosts: train.multihost, batch_size 2,
    gauss_shards 2 (a gauss group inside each host, one camera a host):
    the four ranks' param_checksum equal, and within rtol 1e-5 of the
    two-host camera-parallel run on the same cameras."""
    got = [r["runner_gauss_hosts"] for r in rank_results]
    assert len({g["param_checksum"] for g in got}) == 1
    assert [g["host_views"]["host"] for g in got] == [0, 0, 1, 1]
    np.testing.assert_allclose(got[0]["param_checksum"], rank_results[0]["runner_hosts"]["param_checksum"],
                               rtol=1e-5)


@pytest.fixture(scope="module")
def one_run(ranks):
    """The runner in this process on the same configuration, one block."""
    np.random.seed(0)
    return trunner.training(ranks.runner_cfgs["one"], progress=False, device="cpu")


def test_gauss_shards_through_the_runner(ranks, rank_results, one_run):
    """train.gauss_shards 2 over ranks {0, 1} and with tile_shards 2 over
    {2, 3} against the same run in one process without it: param_checksum,
    num_alive and the log's records; the ranks of a run bit-equal."""
    cfgs_ = ranks.runner_cfgs
    want = read_log(cfgs_["one"])
    for name, pair in (("gauss", (0, 1)), ("gauss_tile", (2, 3))):
        a, b = (rank_results[r]["runner_gauss"] for r in pair)
        assert a["param_checksum"] == b["param_checksum"] and a["num_alive"] == one_run["num_alive"]
        np.testing.assert_allclose(a["param_checksum"], one_run["param_checksum"], rtol=1e-5)
        got = read_log(cfgs_[name])
        assert len(got) == len(want) == 2
        for w, g in zip(want, got):
            assert set(w) == set(g)
            for k in w:
                np.testing.assert_allclose(g[k], w[k], rtol=1e-4, atol=1e-6, err_msg=f"{name} {k}")


def test_resume_and_serve_a_sharded_checkpoint(ranks, rank_results, tmp_path):
    """The gauss run resumed from its checkpoint (the whole state loaded,
    then sharded) to RESUME_ITERS, against the same checkpoint resumed in
    this process without sharding; the checkpoint loads in a
    single-process render, whose PNGs with and without render.parallel
    gauss=2 agree within 1 (u8)."""
    import shutil

    cfgs_ = ranks.runner_cfgs
    res = rank_results[0]["runner_gauss_resume"]
    assert res == rank_results[1]["runner_gauss_resume"] and res["start_iteration"] == RUN_ITERS
    shutil.copytree(cfgs_["gauss"].trained_model_dir, cfgs_["resume_one"].trained_model_dir)
    np.random.seed(0)
    one = trunner.training(cfgs_["resume_one"], progress=False, device="cpu")
    assert one["start_iteration"] == RUN_ITERS
    np.testing.assert_allclose(res["param_checksum"], one["param_checksum"], rtol=1e-5)
    pngs = {}
    for par in ("", "gauss=2"):
        c = copy.deepcopy(cfgs_["gauss"])
        c.render.parallel = par
        c.render.auto_size_capacity = False
        c.model_path = str(tmp_path / f"serve{par.replace('=', '')}")
        np.random.seed(0)
        trunner.render_sets(c, device="cpu")
        d = os.path.join(c.model_path, "train_renders")
        pngs[par] = {f: trunner.imread(os.path.join(d, f)).astype(int) for f in sorted(os.listdir(d))}
    assert list(pngs[""]) == list(pngs["gauss=2"]) and len(pngs[""]) == 2
    for f in pngs[""]:
        assert np.abs(pngs[""][f] - pngs["gauss=2"][f]).max() <= 1, f


def test_plan_layouts_and_refusals(tmp_path):
    """runner.py:405-492's layouts and messages, on _Plan with groups
    that need no process group (nothing is split)."""
    root = str(tmp_path / "seq")
    cpu = torch.device("cpu")
    two = comm.Group(rank=0, size=2, backend="gloo", device=cpu)
    hosts = comm.Group(rank=0, size=2, backend="gloo", device=cpu, hosts=(0, 1))

    def plan(group, *extra):
        return trunner._Plan(t_load_config(None, run_overrides(root, str(tmp_path / "out"), 1, *extra)), group)

    p = plan(None, "train.gauss_shards", "2", "train.tile_shards", "2")
    assert (p.gauss_shards, p.tile_shards, p.gauss_group, p.group) == (2, 2, None, None)
    p = plan(two, "train.gauss_shards", "2")
    assert (p.gauss_group, p.group, p.data_group) == (two, two, None)
    p = plan(hosts, "train.gauss_shards", "2", "train.multihost", "true")
    assert (p.nodes, p.gauss_group) == (2, hosts)
    p = plan(hosts, "train.batch_size", "2", "train.multihost", "true")
    assert (p.nodes, p.node, p.batch, p.data_group) == (2, 0, 2, hosts)
    for group, extra, err, match in (
            (None, ["train.gauss_shards", "2", "train.tile_shards", "2", "train.batch_size", "2"],
             NotImplementedError, "3D data x gauss x tile"),
            (hosts, ["train.tile_shards", "2", "train.multihost", "true"], NotImplementedError,
             "tile_shards across processes"),
            (hosts, ["train.gauss_shards", "3", "train.multihost", "true"], RuntimeError,
             "gauss_shards=3 must be divisible by process_count=2"),
            (hosts, ["train.gauss_shards", "2", "train.batch_size", "3", "train.multihost", "true"], RuntimeError,
             r"multi-host gauss x DP needs batch_size divisible by process_count \(3 % 2\)"),
            (hosts, ["train.multihost", "true"], RuntimeError, "train.multihost with 2 processes requires"),
            (two, ["train.gauss_shards", "4"], RuntimeError, "gauss_shards=4 needs 4 ranks"),
            (two, ["train.gauss_shards", "2", "train.batch_size", "2"], RuntimeError,
             "gauss_shards=2 x batch_size=2 needs 4 ranks, have 2")):
        with pytest.raises(err, match=match):
            plan(group, *extra)


def test_multihost_camera_parallel_needs_one_resolution(tmp_path):
    """runner.py:592-604: hosts stack their batches apart, so multi-host
    camera-DP refuses a scene of two sensor sizes (_Plan.shards checks
    the scene); a scene whose capacity gauss_shards does not divide is
    refused with the JAX runner's message."""
    import types

    hosts = comm.Group(rank=0, size=2, backend="gloo", device=torch.device("cpu"), hosts=(0, 1))
    cfg = t_load_config(None, [*run_overrides(str(tmp_path), str(tmp_path / "out"), 1), "train.batch_size", "2",
                               "train.multihost", "true"])
    views = [types.SimpleNamespace(H=64, W=96), types.SimpleNamespace(H=48, W=96)]
    scene = types.SimpleNamespace(train_views=views, table=types.SimpleNamespace(capacity=512))
    with pytest.raises(RuntimeError, match="multi-host camera-DP requires a single camera resolution"):
        trunner._Plan(cfg, hosts).shards(scene)
    one = types.SimpleNamespace(train_views=views[:1], table=scene.table)
    assert trunner._Plan(cfg, hosts).shards(one).G == 1
    cfg = t_load_config(None, [*run_overrides(str(tmp_path), str(tmp_path / "out"), 1), "train.gauss_shards", "3"])
    with pytest.raises(RuntimeError, match="scene capacity 512 not divisible by gauss_shards=3"):
        trunner._Plan(cfg, None).shards(scene)
