"""The port's training runner against the JAX package's `runner.training`,
and the runner's own rules (mirroring tests/test_train_e2e.py and the
watchdog tests of tests/test_render_sets.py).

Parity: both packages train one Waymo-format sequence (3 frames of
camera 0 at 64x96, the tracked vehicle in view) for 40 iterations on a
configuration that draws nothing (no sky, flip_prob 0, densify_from_iter
above the iteration count), so the JAX PRNGKey stream and the port's
torch.Generator cannot differ in what they decide. The opacity reset
fires at 20, the object-opacity loss (lambda_reg 0.1) starts at 30;
evals at 20 and 40, checkpoints at 20 and 40, the PLY at 40. Each
package gets its own config; numpy's global generator is seeded
identically before each scene build (the actor's grid colours).

Tolerances, and why: the two differ only in the order of f32 sums (the
blend's prefix sums, SSIM's banded products, the backward's reductions)
and in the initial scales' 3-NN distances (1e-6, see
tests/test_torch_waymo_loader.py); 40 Adam steps carry that forward.
* train_log.jsonl: the same records at the same iterations, key for key
  but for obj_acc_loss before the gate (the JAX step renders the actors
  and weighs their loss by 0 there, the port skips that render; as
  tests/test_torch_object_loss.py); integer counts (overflow, alive rows)
  equal, every other value within rtol 1e-4 (measured: 5e-6);
* the final state against JAX's orbax checkpoint at 40, carried over
  with convert.py: parameters under chip_smoke.params_close's rules over
  40 steps (the rows' reference gradient is JAX's first Adam moment at
  40); each Adam moment (the square root of nu) within 1e-2 of its
  leaf's largest value, and within chip_smoke.GRAD_ATOL_SCALED (1e-4) on
  all but LOOSE_GRAD_ROWS (3%) of a Gaussian leaf's rows (measured:
  2.3e-3, 1.3%: 40 steps of gradients at states that differ as above);
  step counts, alive rows and visibility counts equal. But `rot`: the loaded scene starts with
  identity rotations and isotropic scales, where the rotation gradient
  is 0 up to rounding (tests/test_torch_train.py perturbs both for that
  reason), so Adam follows the rounding's sign in each package and 42%
  of the rows with a large moment move apart (measured). `rot` is held
  to params_close's bound for noise-level rows (2 lr per step), and the
  covariance the render reads, R diag(exp(2 log_scale)) R^T, to 1e-3 of
  its largest entry on the rows whose log_scale gradient params_close
  counts as significant (measured: 3.2e-5);
* param_checksum within rtol 1e-5 (measured: 3e-7);
* the PLY at 40: the same header (elements, fields, row counts), every
  field within the state's bound for its parameter.
"""

import copy
import json
import os

import numpy as np
import pytest
import torch

from chip_smoke import GRAD_ATOL_SCALED, LOOSE_GRAD_ROWS, params_close
from street_gaussians_torch import checkpoint as tckpt
from street_gaussians_torch import convert
from street_gaussians_torch import metrics as tmetrics_cli
from street_gaussians_torch import render as trender_cli
from street_gaussians_torch import runner as trunner
from street_gaussians_torch import serve as tserve
from street_gaussians_torch import train as ttrain_cli
from street_gaussians_torch.config import load_config as t_load_config
from street_gaussians_torch.data import waymo as twaymo
from street_gaussians_torch.data.synthetic_waymo import write_synthetic_waymo
from street_gaussians_torch.train_lib import flatten_params
from street_gaussians_torch.utils import ply as tply
from street_gaussians_tpu import checkpoint as jckpt
from street_gaussians_tpu import runner as jrunner
from street_gaussians_tpu import train_lib as jtrain
from street_gaussians_tpu.config import load_config as j_load_config
from street_gaussians_tpu.data import waymo as jwaymo
from test_torch_train import numpy_tree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ITERS = 40
INT_KEYS = ("overflow", "overflow_instance", "overflow_tile", "num_alive")
COV_RTOL = 1e-3
MOMENT_ATOL = 1e-2


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for the port's tiny tensors: with the suite's
    parallel workers, eight threads a process spend about four times the
    CPU time of one on the same tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def small_sensors(monkeypatch):
    for mod in (jwaymo, twaymo):
        monkeypatch.setattr(mod, "IMAGE_HEIGHTS", [64] * 5)
        monkeypatch.setattr(mod, "IMAGE_WIDTHS", [96] * 5)


def draw_free_overrides(root: str, model_path: str, iterations: int = ITERS):
    """KEY VALUE overrides of the configuration that draws nothing: no
    sky, no flip, no densify; the reset at 20 and the object loss from
    30."""
    return [
        "source_path", root, "model_path", model_path, "data.type", "Waymo", "data.split_train", "1",
        "data.split_test", "-1", "data.cameras", "[0]", "model.nsg.include_sky", "false",
        "model.gaussian.flip_prob", "0", "optim.lambda_reg", "0.1", "optim.densify_from_iter", "1000",
        "optim.densify_until_iter", "30", "optim.opacity_reset_interval", "20", "train.iterations", str(iterations),
        "train.test_iterations", "[20, 40]", "train.save_iterations", "[40]",
        "train.checkpoint_iterations", "[20, 40]", "render.tile_capacity", "0", "render.instance_capacity", "32768",
    ]


def write_sequence(root: str, num_frames: int = 3, actor_in_view: bool = True):
    write_synthetic_waymo(root, num_frames=num_frames, cameras=(0,), actor_in_view=actor_in_view)


def read_log(cfg):
    with open(os.path.join(cfg.record_dir, "train_log.jsonl")) as f:
        return [json.loads(line) for line in f]


def jax_state_at(jcfg, iteration: int):
    """The JAX package's orbax checkpoint at `iteration`, carried over to
    the port (CPU)."""
    np.random.seed(0)
    jscene = jrunner.build_scene(jcfg)
    tpl = jtrain.init_train_state(jrunner.build_initial_params(jcfg, jscene), jscene.aux_init)
    js, it = jckpt.load_train_state(jcfg.trained_model_dir, tpl, iteration)
    assert it == iteration
    adam = {k: numpy_tree(getattr(js.adam, k)) for k in ("mu", "nu", "count")}
    return convert.train_state_from_numpy(numpy_tree(js.params), adam, numpy_tree(js.aux), js.step, "cpu")


def port_state_at(tcfg, iteration: int):
    np.random.seed(0)
    scene = trunner.build_scene(tcfg, device="cpu")
    tpl = trunner.init_train_state(trunner.build_initial_params(tcfg, scene, device="cpu"), scene.aux_init)
    s, it = tckpt.load_train_state(tcfg.trained_model_dir, tpl, iteration)
    assert it == iteration
    return s


@pytest.fixture(scope="module")
def parity(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("runner_parity")
    root = str(tmp / "seq")
    write_sequence(root)
    jcfg = j_load_config(None, draw_free_overrides(root, str(tmp / "jax")))
    tcfg = t_load_config(None, draw_free_overrides(root, str(tmp / "port")))
    np.random.seed(0)
    jfinal = jrunner.training(copy.deepcopy(jcfg), progress=False)
    np.random.seed(0)
    tfinal = trunner.training(copy.deepcopy(tcfg), progress=False, device="cpu")
    return dict(jcfg=jcfg, tcfg=tcfg, jfinal=jfinal, tfinal=tfinal,
                jstate=jax_state_at(jcfg, ITERS), tstate=port_state_at(tcfg, ITERS))


def test_train_log_matches_jax(parity):
    want, got = read_log(parity["jcfg"]), read_log(parity["tcfg"])
    gate = parity["tcfg"].optim.densify_until_iter
    assert [r["iteration"] for r in got] == [r["iteration"] for r in want] == [10, 20, 20, 30, 40, 40]
    for w, g in zip(want, got):
        it = w["iteration"]
        if "loss" in w and it <= gate:
            assert set(w) - set(g) == {"obj_acc_loss"} and set(g) <= set(w), it
        else:
            assert set(g) == set(w), (it, set(g) ^ set(w))
        for k in set(g) & set(w):
            if k in INT_KEYS or k == "iteration":
                assert g[k] == w[k], (it, k)
            else:
                np.testing.assert_allclose(g[k], w[k], rtol=1e-4, atol=1e-6, err_msg=f"{k} at {it}")
    assert any("obj_acc_loss" in r and r["obj_acc_loss"] > 0 for r in got)
    evals = [r["train_psnr"] for r in got if "train_psnr" in r]
    assert len(evals) == 2 and evals[1] > evals[0]


def _lr_bound(cfg, name):
    o = cfg.optim
    return {
        "gaussians.xyz": o.position_lr_init * 20.0, "gaussians.feat_dc": o.feature_lr,
        "gaussians.feat_rest": o.feature_lr / 20.0, "gaussians.log_scale": o.scaling_lr,
        "gaussians.rot": o.rotation_lr, "gaussians.opacity_logit": o.opacity_lr,
        "actor_pose.opt_trans": o.track_position_lr_init, "actor_pose.opt_rots": o.track_rotation_lr_init,
    }.get(name, 0.0)


def covariance(rot, log_scale):
    """[C, 3, 3] R diag(exp(2 log_scale)) R^T in float64: what the render
    reads of a row's rotation and scales."""
    q = rot.numpy().astype(np.float64)
    w, x, y, z = (q / np.linalg.norm(q, axis=1, keepdims=True)).T
    R = np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
                  2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
                  2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], 1).reshape(-1, 3, 3)
    s2 = np.exp(2 * log_scale.numpy().astype(np.float64))
    return R @ (s2[:, :, None] * np.transpose(R, (0, 2, 1)))


def test_final_state_matches_jax(parity):
    s, js = parity["tstate"], parity["jstate"]
    assert s.step == js.step == ITERS
    got_p, want_p = flatten_params(s.params), flatten_params(js.params)
    assert set(got_p) == set(want_p)
    for k in want_p:
        lr = _lr_bound(parity["tcfg"], k)
        if k == "gaussians.rot":  # noise-level gradients: the loose bound, and the covariance below
            assert np.abs(got_p[k].numpy() - want_p[k].numpy()).max() <= 2 * lr * ITERS, k
            continue
        params_close(got_p[k].numpy(), want_p[k].numpy(), js.adam.mu[k].numpy(), lr, ITERS, k)
    sig_got, sig_want = (covariance(p["gaussians.rot"], p["gaussians.log_scale"]) for p in (got_p, want_p))
    rel = np.abs(sig_got - sig_want).reshape(-1, 9).max(1) / np.abs(sig_want).reshape(-1, 9).max(1)
    g = np.abs(js.adam.mu["gaussians.log_scale"].numpy()).max(1)
    sig = g >= 0.01 * g.max()  # the rows params_close holds log_scale tightly on
    assert sig.sum() > 20 and rel[sig].max() <= COV_RTOL, rel[sig].max()
    for mom in ("mu", "nu"):
        for k, v in getattr(s.adam, mom).items():
            w = getattr(js.adam, mom)[k].numpy()
            v = v.numpy()
            if mom == "nu":  # squared gradients: compare their roots
                v, w = np.sqrt(v), np.sqrt(w)
            d = np.abs(v - w).reshape(len(v), -1).max(1) / max(float(np.abs(w).max()), 1e-30)
            assert d.max() <= MOMENT_ATOL and (len(d) < 100 or (d > GRAD_ATOL_SCALED).mean() <= LOOSE_GRAD_ROWS), \
                (mom, k, d.max(), (d > GRAD_ATOL_SCALED).mean())
    for k, v in s.adam.count.items():
        np.testing.assert_array_equal(v.numpy(), js.adam.count[k].numpy(), err_msg=f"count {k}")
    np.testing.assert_array_equal(s.aux.alive.numpy(), js.aux.alive.numpy())
    np.testing.assert_array_equal(s.aux.model_id.numpy(), js.aux.model_id.numpy())
    np.testing.assert_array_equal(s.aux.denom.numpy(), js.aux.denom.numpy())


def test_final_metrics_match_jax(parity):
    jf, tf = parity["jfinal"], parity["tfinal"]
    assert tf["num_alive"] == jf["num_alive"]
    np.testing.assert_allclose(tf["param_checksum"], jf["param_checksum"], rtol=1e-5)
    np.testing.assert_allclose([tf["ema_loss"], tf["ema_psnr"]], [jf["ema_loss"], jf["ema_psnr"]], rtol=1e-4)
    # the checksum of the state saved at 40 is the run's own
    assert trunner.param_checksum(parity["tstate"].params) == tf["param_checksum"]


def test_ply_matches_jax(parity):
    paths = [os.path.join(c.point_cloud_dir, f"iteration_{ITERS}", "point_cloud.ply")
             for c in (parity["jcfg"], parity["tcfg"])]
    heads = []
    for p in paths:
        with open(p, "rb") as f:
            data = f.read()
        heads.append(data[:data.index(b"end_header\n")])
    assert heads[0] == heads[1]
    want, got = (tply.read_ply(p) for p in paths)
    assert list(got) == list(want) == ["vertex_background", "vertex_obj_007"]
    field_leaf = {"x": "xyz", "y": "xyz", "z": "xyz", "f_dc": "feat_dc", "f_rest": "feat_rest", "opacity": "opacity_logit",
                  "scale": "log_scale", "rot": "rot", "semantic": "semantic"}
    for el in want:
        for name in want[el].dtype.names:
            leaf = field_leaf.get(name.rstrip("0123456789").rstrip("_"))
            bound = 2 * _lr_bound(parity["tcfg"], f"gaussians.{leaf}") * ITERS + 1e-6
            if name in ("nx", "ny", "nz"):
                bound = 0.0
            d = np.abs(got[el][name] - want[el][name]).max()
            assert d <= bound, (el, name, d, bound)


def test_save_config_snapshot(parity):
    from street_gaussians_torch.utils import yaml_subset

    path = os.path.join(parity["tcfg"].model_path, "configs", "config_train.yaml")
    snap = yaml_subset.load_file(path)
    assert snap["train"]["iterations"] == ITERS and snap["optim"]["lambda_reg"] == 0.1
    assert snap["model_path"] == parity["tcfg"].model_path


# ---------------------------------------------------------------- port only


@pytest.fixture(scope="module")
def small_seq(tmp_path_factory):
    """The JAX watchdog tests' sequence: 2 frames, the vehicle out of
    view (about 440 instances a view)."""
    root = str(tmp_path_factory.mktemp("small_seq") / "seq")
    write_sequence(root, num_frames=2, actor_in_view=False)
    return root


def small_cfg(root, model_path, iterations, *extra):
    return t_load_config(None, [
        "source_path", root, "model_path", model_path, "data.type", "Waymo", "data.split_train", "1",
        "data.cameras", "[0]", "model.nsg.include_sky", "false", "optim.densify_until_iter", "0",
        "optim.opacity_reset_interval", "1000000", "train.iterations", str(iterations),
        "train.test_iterations", "[]", "train.save_iterations", "[]", "train.checkpoint_iterations", "[]",
        "render.tile_capacity", "128", "capacity.background_growth", "1", "capacity.actor_growth", "1", *extra])


def test_overflow_watchdog_grows_the_capacity(small_seq, tmp_path, capsys):
    """A starved instance capacity (256, the scene needs ~440) overflows
    in 10 of 10 samples: the watchdog doubles it at iteration 100 and
    rebuilds the step (cfg.render written, as the JAX runner writes it),
    and training goes on at 512."""
    cfg = small_cfg(small_seq, str(tmp_path / "out"), 110, "render.instance_capacity", "256")
    final = trunner.training(cfg, progress=False, device="cpu")
    text = capsys.readouterr().out
    assert "[overflow] instance_capacity=256 exceeded in 10/10 recent samples" in text
    assert "growing instance_capacity -> 512" in text
    recs = read_log(cfg)
    assert [r["iteration"] for r in recs] == list(range(10, 111, 10)) and all("event" not in r for r in recs)
    assert final["growth"] == [{"iteration": 100, "capacity": "instance_capacity", "from": 256, "to": 512,
                                "hits": 10}]
    assert cfg.render.instance_capacity == 512
    assert recs[-1]["overflow_instance"] < recs[-2]["overflow_instance"]


def feed(watchdog, log_f, samples, start=10):
    """Samples (instance drops, tile drops) every 10 iterations; the
    iterations at which a capacity grew."""
    grew = []
    for k, (ovf_i, ovf_t) in enumerate(samples):
        if watchdog.sample(start + 10 * k, float(ovf_i), float(ovf_t), log_f):
            grew.append(start + 10 * k)
    return grew


@pytest.mark.parametrize("case", ["hits", "budget", "ceiling warn", "ceiling error", "no growth error", "tile"])
def test_overflow_watchdog_rule(tmp_path, capsys, case):
    """The watchdog's rule (runner.py:873-953) on its own samples: a
    window of 10 samples, growth at 5 or more hits, a grow budget per
    capacity, the max_instance_capacity ceiling, a tile capacity that
    goes uncapped once it reaches the instance capacity, and past growth
    overflow_policy 'warn' (train on) or 'error' (raise, with a
    capacity_overflow record)."""
    cfg = t_load_config(None, ["render.instance_capacity", "256", "render.tile_capacity", "0",
                               "render.grow_budget", "2", "render.max_instance_capacity", "4096"])
    log = tmp_path / "log.jsonl"
    with open(log, "w") as log_f:
        if case == "hits":  # 4 of 10, then 5 of 10
            assert feed(trunner._Watchdog(cfg), log_f, [(1, 0)] * 4 + [(0, 0)] * 6 + [(1, 0)] * 5 + [(0, 0)] * 5) \
                == [200]
            assert cfg.render.instance_capacity == 512
        elif case == "budget":  # two doublings, then the budget is spent: warn
            cfg.render.overflow_policy = "warn"
            assert feed(trunner._Watchdog(cfg), log_f, [(7, 0)] * 30) == [100, 200]
            assert cfg.render.instance_capacity == 1024
            assert "remaining budget" not in capsys.readouterr().out
        elif case == "ceiling warn":
            cfg.render.max_instance_capacity = 256
            cfg.render.overflow_policy = "warn"
            wd = trunner._Watchdog(cfg)
            assert feed(wd, log_f, [(7, 0)] * 20) == [] and wd.events == []
            assert cfg.render.instance_capacity == 256
        elif case in ("ceiling error", "no growth error"):
            if case == "ceiling error":
                cfg.render.max_instance_capacity = 256
            else:
                cfg.render.auto_grow_capacity = False
            with pytest.raises(RuntimeError, match="instance_capacity=256 persistently exceeded at iteration 100"):
                feed(trunner._Watchdog(cfg), log_f, [(7, 0)] * 10)
        else:  # a tile cap of 128 under an instance capacity of 256: 256, then uncapped
            cfg.render.tile_capacity = 128
            assert feed(trunner._Watchdog(cfg), log_f, [(0, 3)] * 20) == [100, 200]
            assert cfg.render.tile_capacity == 0 and cfg.render.instance_capacity == 256
    recs = [json.loads(line) for line in open(log)]
    if case.endswith("error"):
        assert recs == [{"iteration": 100, "event": "capacity_overflow", "capacity": "instance_capacity",
                         "value": 256, "dropped": 7.0}]
    else:
        assert recs == []


@pytest.fixture(scope="module")
def resumed(small_seq, tmp_path_factory):
    """30 iterations with densify every 10 from 5 until 25 and a
    checkpoint at 30, then the same config to 40: the second run resumes."""
    out = str(tmp_path_factory.mktemp("resume") / "out")
    opts = ["render.instance_capacity", "4096", "optim.densify_from_iter", "5", "optim.densification_interval", "10",
            "optim.densify_until_iter", "25", "train.checkpoint_iterations", "[30, 40]"]
    first = trunner.training(small_cfg(small_seq, out, 30, *opts), progress=False, device="cpu")
    records = read_log(small_cfg(small_seq, out, 30))
    second = trunner.training(small_cfg(small_seq, out, 40, *opts), progress=False, device="cpu")
    return dict(first=first, second=second, records=records, cfg=small_cfg(small_seq, out, 40))


def test_densify_records_at_the_reference_iterations(resumed):
    dens = [r for r in resumed["records"] if any(k.startswith("densify/") for k in r)]
    # iteration > densify_from_iter, iteration % interval == 0, iteration < densify_until_iter
    assert [r["iteration"] for r in dens] == [10, 20]
    assert all(r["densify/points_order_sensitive"] == 0 for r in dens)
    assert all(isinstance(v, int) for r in dens for k, v in r.items())


def test_resume_continues_at_the_next_iteration(resumed, capsys):
    assert resumed["first"]["start_iteration"] == 0 and resumed["second"]["start_iteration"] == 30
    recs = read_log(resumed["cfg"])
    assert [r["iteration"] for r in recs if "loss" in r] == [10, 20, 30, 40]
    s = port_state_at(resumed["cfg"], 40)
    assert s.step == 40


def test_white_background_resets_opacity_at_densify_from_iter(small_seq, tmp_path):
    """runner.py:845-851: under data.white_background the opacities are
    reset once more at densify_from_iter."""
    cfg = small_cfg(small_seq, str(tmp_path / "out"), 10, "render.instance_capacity", "4096",
                    "data.white_background", "true", "optim.densify_from_iter", "10",
                    "optim.densify_until_iter", "100", "train.checkpoint_iterations", "[10]")
    trunner.training(cfg, progress=False, device="cpu")
    s = port_state_at(cfg, 10)
    op = torch.sigmoid(s.params.gaussians.opacity_logit[s.aux.alive])
    assert float(op.max()) <= 0.01 + 1e-7


def test_non_finite_loss_fails_loudly(small_seq, tmp_path):
    cfg = small_cfg(small_seq, str(tmp_path / "out"), 20, "render.instance_capacity", "4096", "optim.lambda_l1",
                    ".nan")
    with pytest.raises(RuntimeError, match="non-finite loss nan at iteration 10"):
        trunner.training(cfg, progress=False, device="cpu")
    rec = read_log(cfg)[-1]
    assert rec["event"] == "non_finite_loss" and rec["iteration"] == 10 and np.isnan(rec["loss"])


def test_unported_branches_raise(small_seq, tmp_path):
    """The viewer (item 5) is the one branch left unported; the
    Gaussian-sharded and multi-host branches (item 6b) run
    (tests/test_torch_parallel_gauss.py), and refuse a scene whose
    capacity gauss_shards does not divide with the JAX runner's message."""
    cfg = small_cfg(small_seq, str(tmp_path / "out"), 1, "viewer.enabled", "true")
    with pytest.raises(NotImplementedError, match="item 5"):
        trunner.training(cfg, progress=False, device="cpu")
    cfg = small_cfg(small_seq, str(tmp_path / "out"), 1, "train.gauss_shards", "3")
    with pytest.raises(RuntimeError, match="not divisible by gauss_shards=3"):
        trunner.training(cfg, progress=False, device="cpu")


def test_clis_with_config(tmp_path, capsys):
    """train, render (both modes) and metrics in-process on the real
    Waymo recipe file (configs/example/waymo_train_002.yaml over its
    parent), cut to 10 iterations of a 2-frame sequence, a 32-texel sky."""
    root = str(tmp_path / "seq")
    write_sequence(root, num_frames=2)
    opts = ["source_path", root, "model_path", str(tmp_path / "out"), "data.selected_frames", "[0, 1]",
            "data.cameras", "[0]", "data.use_tracker", "false", "model.sky.resolution", "32",
            "train.iterations", "10", "train.test_iterations", "[10]", "train.save_iterations", "[10]",
            "train.checkpoint_iterations", "[10]", "render.instance_capacity", "32768",
            "capacity.background_growth", "1", "capacity.actor_growth", "1"]
    argv = ["--config", os.path.join(REPO, "configs/example/waymo_train_002.yaml"), "--device", "cpu", *opts]
    final = ttrain_cli.main(argv)
    assert np.isfinite(final["param_checksum"]) and final["iterations"] == 10
    assert os.path.exists(os.path.join(str(tmp_path / "out"), "trained_model", "iteration_10", tckpt.STATE_FILE))
    out = trender_cli.main(argv)
    assert out["fps"] > 0 and out["fps_throughput"] > 0
    assert sorted(os.listdir(tmp_path / "out" / "train_renders")) == ["000000_0_rgb.png", "000001_0_rgb.png"]
    res = tmetrics_cli.main(argv)
    text = capsys.readouterr().out
    assert json.loads(text.strip().splitlines()[-1]) == {"train": {m: res["train"][m] for m in ("psnr", "ssim")}}
    assert np.isfinite(res["train"]["psnr"]) and 0 < res["train"]["ssim"] <= 1
    traj = trender_cli.main(argv[:4] + ["--mode", "trajectory"] + argv[4:] + ["render.save_video", "false"])
    assert traj["num_frames"] == 2
    assert sorted(os.listdir(traj["out_dir"])) == sorted(
        f"00000{i}_0_{c}.png" for i in range(2) for c in ("rgb", "object", "background", "depth", "acc"))


def test_cli_without_config_runs_the_bench_cell(monkeypatch, capsys):
    """No --config: the bench cell (here shrunk to 64x96) as before."""
    orig = ttrain_cli.bench_train_cell
    monkeypatch.setattr(ttrain_cli, "bench_train_cell", lambda device, seed: orig(
        device, seed, sky_resolution=16, num_bkgd=600, num_actors=2, H=64, W=96))
    monkeypatch.setattr(tserve, "INSTANCE_CAPACITY", 2**15)
    assert ttrain_cli.main(["--device", "cpu", "--steps", "1"]) is None
    lines = capsys.readouterr().out.strip().splitlines()
    step, summary = json.loads(lines[-2]), json.loads(lines[-1])
    assert step["step"] == 4 and np.isfinite(step["loss"]) and summary["steps"] == 1
    with pytest.raises(SystemExit):
        ttrain_cli.main(["--device", "cpu", "train.iterations", "5"])
