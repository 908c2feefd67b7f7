"""The port's render_sets and evaluate_metrics against the JAX package's
(mirroring tests/test_render_sets.py), from one state in both packages.

The state is the JAX package's orbax checkpoint of the runner tests'
draw-free configuration (tests/test_torch_runner.py), cut to 10
iterations, with a 32-texel sky cubemap added from a seeded generator so
that the eval path's sky (its table built once) is covered; eval mode
draws nothing. The JAX render gets that state and the scene as training
built it; the port's render_sets loads the same state, carried over with
convert.py and saved with its own save_train_state, from its checkpoint
(its CLI path). Both render at one fixed capacity
(auto_size_capacity false), so that JAX compiles once.

Tolerances: the PNGs within 1 per channel (u8 rounding of renders that
agree to 1e-5, tests/test_torch_render.py); the metrics of the same PNGs
within rtol 1e-5 (the same f32 operations in another order), SSIM also
within 2e-6 absolute (a mean of per-pixel terms that cancel to ~0.09;
measured 9.4e-7); the
per-view capacities equal JAX's rule applied to JAX's own
sum(tiles_touched).
"""

import copy
import dataclasses
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from street_gaussians_torch import checkpoint as tckpt
from street_gaussians_torch import convert
from street_gaussians_torch import runner as trunner
from street_gaussians_torch.config import load_config as t_load_config
from street_gaussians_torch.models.sky_cubemap import SkyParams as TSkyParams
from street_gaussians_torch.utils.image_io import imread
from street_gaussians_tpu import checkpoint as jckpt
from street_gaussians_tpu import runner as jrunner
from street_gaussians_tpu import train_lib as jtrain
from street_gaussians_tpu.config import load_config as j_load_config
from street_gaussians_tpu.models.renderer import screen_space as j_screen_space
from street_gaussians_tpu.models.sky_cubemap import SkyParams as JSkyParams
from test_torch_runner import draw_free_overrides, one_thread, small_sensors, write_sequence  # noqa: F401
from test_torch_train import numpy_tree

ITERS = 10
SKY = 32


def render_overrides(root, model_path):
    return [*draw_free_overrides(root, model_path, ITERS), "train.test_iterations", "[]",
            "train.save_iterations", "[]", "train.checkpoint_iterations", f"[{ITERS}]"]


def serve_cfg(load, root, model_path, *extra):
    cfg = load(None, [*render_overrides(root, model_path), "model.nsg.include_sky", "true",
                      "model.sky.resolution", str(SKY), "render.auto_size_capacity", "false", *extra])
    cfg.mode = "evaluate"
    return cfg


def pngs(cfg):
    d = os.path.join(cfg.model_path, "train_renders")
    return {f: imread(os.path.join(d, f)) for f in sorted(os.listdir(d))}


def jax_ladder(maxcap):
    """runner.py:1175-1181."""
    ladder, c = [], 1024
    while c < maxcap:
        ladder.append(c)
        c = (int(c * 1.5) + 127) // 128 * 128
    return ladder + [maxcap]


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("render_sets")
    root = str(tmp / "seq")
    write_sequence(root)
    # the JAX checkpoint at 10, without sky
    jtrain_cfg = j_load_config(None, render_overrides(root, str(tmp / "jax")))
    np.random.seed(0)
    jrunner.training(copy.deepcopy(jtrain_cfg), progress=False)
    np.random.seed(0)
    jscene = jrunner.build_scene(jtrain_cfg)
    tpl = jtrain.init_train_state(jrunner.build_initial_params(jtrain_cfg, jscene), jscene.aux_init)
    js, _ = jckpt.load_train_state(jtrain_cfg.trained_model_dir, tpl, ITERS)
    cubemap = np.random.default_rng(5).uniform(0.1, 0.9, (3, 6 * SKY * SKY)).astype(np.float32)
    js = dataclasses.replace(js, params=dataclasses.replace(js.params, sky=JSkyParams(cubemap=jnp.asarray(cubemap))))

    # the same state in the port, saved by the port
    adam = {k: numpy_tree(getattr(js.adam, k)) for k in ("mu", "nu", "count")}
    for k in ("mu", "nu"):
        adam[k]["sky"] = {"cubemap": np.zeros_like(cubemap)}
    adam["count"]["sky"] = {"cubemap": np.zeros((), np.float32)}
    ts = convert.train_state_from_numpy(numpy_tree(js.params), adam, numpy_tree(js.aux), js.step, "cpu")
    assert isinstance(ts.params.sky, TSkyParams)
    tcfg = serve_cfg(t_load_config, root, str(tmp / "port"))
    tckpt.save_train_state(tcfg.trained_model_dir, ITERS, ts)

    jcfg = serve_cfg(j_load_config, root, str(tmp / "jax"))
    jout = jrunner.render_sets(copy.deepcopy(jcfg), state=js, scene=jscene)
    before = copy.deepcopy(tcfg).to_dict()
    tout = trunner.render_sets(tcfg, device="cpu")
    assert tcfg.to_dict() == before
    return dict(tmp=tmp, root=root, js=js, jscene=jscene, jcfg=jcfg, tcfg=tcfg, jout=jout, tout=tout,
                pngs=pngs(tcfg))


def test_pngs_match_jax(served):
    want, got = pngs(served["jcfg"]), served["pngs"]
    assert list(got) == list(want) == ["000000_0_rgb.png", "000001_0_rgb.png", "000002_0_rgb.png"]
    for name in want:
        assert got[name].shape == want[name].shape == (64, 96, 3)
        d = np.abs(got[name].astype(int) - want[name].astype(int))
        assert d.max() <= 1, (name, d.max(), (d > 0).mean())
    assert served["tout"]["fps"] > 0 and served["tout"]["fps_throughput"] > 0 and served["tout"]["regrows"] == []


def test_evaluate_metrics_matches_jax(served, tmp_path):
    """Both packages' metrics of the same (the port's) PNGs."""
    tcfg = copy.deepcopy(served["tcfg"])
    got = trunner.evaluate_metrics(tcfg, device="cpu")
    jcfg = copy.deepcopy(served["jcfg"])
    jcfg.model_path = str(tmp_path / "jax_metrics")
    shutil.copytree(os.path.join(tcfg.model_path, "train_renders"), os.path.join(jcfg.model_path, "train_renders"))
    want = jrunner.evaluate_metrics(jcfg)
    assert set(got) == set(want) == {"train"}
    assert set(got["train"]) == set(want["train"]) == {"psnr", "ssim", "per_view"}
    for g, w in zip(got["train"]["per_view"], want["train"]["per_view"]):
        assert g["name"] == w["name"] and set(g) == set(w)
        np.testing.assert_allclose(g["psnr"], w["psnr"], rtol=1e-5)
        np.testing.assert_allclose(g["ssim"], w["ssim"], rtol=1e-5, atol=2e-6)
    assert os.path.exists(os.path.join(tcfg.model_path, "results_train.json"))


def test_view_capacities_follow_the_jax_rule(served, tmp_path):
    """Demand probe on: each view's capacity is the first rung of the
    ladder that holds JAX's sum(tiles_touched) of that view; the renders
    equal the fixed-capacity ones (nothing dropped)."""
    cfg = copy.deepcopy(served["tcfg"])
    cfg.render.auto_size_capacity = True
    out = trunner.render_sets(cfg, device="cpu")
    js, scene = served["js"], served["jscene"]
    opts = jrunner.render_opts_from_cfg(served["jcfg"], "eval")
    ladder = jax_ladder(int(cfg.render.get("max_instance_capacity", 2**23)))
    want = {}
    for v in scene.test_views + scene.train_views:
        screen, _ = j_screen_space(js.params, js.aux, scene.table, scene.pose_data, v.frame_input,
                                   step=jnp.asarray(10**9), opts=opts)
        need = max(int(jax.device_get(jnp.sum(screen.tiles_touched))), 1024)
        want[v.image_name] = next(c for c in ladder if c >= need)
    assert out["view_capacities"] == want
    assert sum(out["capacities"].values()) == 3 and out["regrows"] == []
    for name, img in pngs(cfg).items():
        np.testing.assert_array_equal(img, served["pngs"][name], err_msg=name)


def test_regrow_on_overflow(served, capsys):
    """A starved capacity and no probe: each view regrows up the ladder
    and re-renders until nothing drops (cfg untouched)."""
    cfg = copy.deepcopy(served["tcfg"])
    cfg.render.instance_capacity = 128
    before = copy.deepcopy(cfg).to_dict()
    out = trunner.render_sets(cfg, device="cpu")
    assert cfg.to_dict() == before
    text = capsys.readouterr().out
    assert "[render] overflow at 000000_0" in text and len(out["regrows"]) >= 3
    assert all(r["to"] > r["from"] for r in out["regrows"])
    for name, img in pngs(cfg).items():
        np.testing.assert_array_equal(img, served["pngs"][name], err_msg=name)


def test_ceiling_renders_with_drops(served, capsys):
    cfg = copy.deepcopy(served["tcfg"])
    cfg.render.instance_capacity = 256
    cfg.render.max_instance_capacity = 256
    before = copy.deepcopy(cfg).to_dict()
    out = trunner.render_sets(cfg, device="cpu")
    assert cfg.to_dict() == before
    text = capsys.readouterr().out
    assert "demand exceeds max_instance_capacity=256" in text
    assert text.count("demand exceeds") <= 3 and out["regrows"] == []
    assert "fps" in out and len(pngs(cfg)) == 3


def test_no_checkpoint_raises(served, tmp_path):
    cfg = copy.deepcopy(served["tcfg"])
    cfg.trained_model_dir = str(tmp_path / "none")
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        trunner.render_sets(cfg, device="cpu")


def test_sky_table_is_built_once(served, monkeypatch):
    calls = []
    orig = trunner.build_sky_table
    monkeypatch.setattr(trunner, "build_sky_table", lambda cm: calls.append(1) or orig(cm))
    from street_gaussians_torch.models import sky_cubemap

    monkeypatch.setattr(sky_cubemap, "build_sky_table", lambda cm: calls.append(2) or orig(cm))
    cfg = copy.deepcopy(served["tcfg"])
    cfg.render.save_image = False
    trunner.render_sets(cfg, device="cpu")
    assert calls == [1]


def test_serve_prune_opacity(served, capsys):
    """(tests/test_render_sets.py::test_render_sets_serve_prune) 'auto'
    keeps the largest candidate threshold whose probe renders stay within
    1/255 of the exact ones: every view within 3 of the exact PNG; an
    explicit 0.5 drops Gaussians and still renders."""
    cfg = copy.deepcopy(served["tcfg"])
    cfg.render.serve_prune_opacity = "auto"
    assert trunner.render_sets(cfg, device="cpu")["fps"] > 0
    assert "[render] serve_prune_opacity auto ->" in capsys.readouterr().out
    for name, img in pngs(cfg).items():
        assert np.abs(img.astype(int) - served["pngs"][name].astype(int)).max() <= 3, name
    cfg.render.serve_prune_opacity = 0.5
    assert trunner.render_sets(cfg, device="cpu")["fps"] > 0
    assert "[render] serve-time prune: opacity < 0.5000 drops" in capsys.readouterr().out


def test_trace_dir_writes_a_profiler_trace(served, tmp_path):
    cfg = copy.deepcopy(served["tcfg"])
    cfg.render.trace_dir = str(tmp_path / "trace")
    cfg.render.save_image = False
    trunner.render_sets(cfg, device="cpu")
    with open(tmp_path / "trace" / "render_sets_trace.json") as f:
        assert any(e.get("name") == "screen_space" for e in json.load(f)["traceEvents"])
