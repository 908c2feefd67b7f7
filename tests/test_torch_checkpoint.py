"""The port's checkpoints and PLY export against the JAX package's
(mirroring tests/test_checkpoint.py).

The port saves its own torch state (street_gaussians_torch/checkpoint.py)
where the JAX package saves an orbax pytree; the two meet through
convert.train_state_from_numpy and through the PLY file. Tolerances:
none. The state round trip is bit-equal, the PLY written from a state
carried over from JAX is byte-equal to JAX's, the PLY loaded back equals
JAX's load, and the scene artifacts (input.ply, cameras.json) equal
JAX's.
"""

import dataclasses
import filecmp
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from street_gaussians_torch import checkpoint as tckpt
from street_gaussians_torch import convert
from street_gaussians_torch import runner as trunner
from street_gaussians_torch.config import default_config as t_default_config
from street_gaussians_torch.data.synthetic_waymo import write_synthetic_waymo
from street_gaussians_torch.train_lib import flatten_params
from street_gaussians_tpu import checkpoint as jckpt
from street_gaussians_tpu import runner as jrunner
from street_gaussians_tpu import train_lib as jtrain
from street_gaussians_tpu.config import default_config as j_default_config
from street_gaussians_tpu.data.synthetic import make_synthetic_scene
from street_gaussians_tpu.models.renderer import SceneParams
from street_gaussians_tpu.models.sky_cubemap import init_sky
from test_torch_train import numpy_tree


@pytest.fixture(scope="module")
def states():
    """A JAX train state of the synthetic scene with a sky (every leaf
    filled from a seeded generator, a few rows dead) and the port's copy
    of it."""
    scene = make_synthetic_scene(num_bkgd=150, num_actors=1, H=32, W=48)
    params = SceneParams(gaussians=scene.params_init, actor_pose=scene.pose_params_init, sky=init_sky(16, False),
                         color_correction=None, pose_correction=None)
    js = jtrain.init_train_state(params, scene.aux)
    rng = np.random.default_rng(0)
    fill = lambda x: jnp.asarray(rng.normal(size=x.shape).astype(np.asarray(x).dtype))  # noqa: E731
    alive = np.asarray(js.aux.alive) & (rng.uniform(size=js.aux.alive.shape) > 0.1)
    js = dataclasses.replace(
        js,
        params=jax.tree.map(fill, js.params),
        adam=js.adam._replace(mu=jax.tree.map(fill, js.adam.mu), nu=jax.tree.map(lambda x: fill(x) ** 2, js.adam.nu)),
        aux=dataclasses.replace(js.aux, alive=jnp.asarray(alive), denom=fill(js.aux.denom)),
        step=jnp.asarray(7, jnp.int32),
    )
    adam = {k: numpy_tree(getattr(js.adam, k)) for k in ("mu", "nu", "count")}
    ts = convert.train_state_from_numpy(numpy_tree(js.params), adam, numpy_tree(js.aux), js.step, "cpu")
    table = convert.scene_from_numpy(numpy_tree(js.params), numpy_tree(js.aux), numpy_tree(scene.table), None,
                                     "cpu")[2]
    return dict(jax=js, port=ts, jtable=scene.table, table=table)


def test_state_round_trip_is_bit_equal(states, tmp_path):
    s = states["port"]
    d = str(tmp_path / "trained_model")
    tckpt.save_train_state(d, 123, s)
    assert os.path.isdir(os.path.join(d, "iteration_123"))
    assert tckpt.search_max_iteration(d) == 123
    restored, it = tckpt.load_train_state(d, s)
    assert it == 123 and restored.step == s.step == 7
    want, got = tckpt.state_to_flat(s), tckpt.state_to_flat(restored)
    assert set(got) == set(want) and len(want) > 20
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k
    # re-saved, the file holds the same leaves bit for bit
    tckpt.save_train_state(d, 124, restored)
    again, _ = tckpt.load_train_state(d, s, iteration=124)
    for k, v in tckpt.state_to_flat(again).items():
        assert torch.equal(v, want[k]), k


def test_search_max_iteration_agrees_with_jax(tmp_path):
    assert tckpt.search_max_iteration(str(tmp_path / "missing")) is jckpt.search_max_iteration(
        str(tmp_path / "missing")) is None
    d = tmp_path / "ckpts"
    d.mkdir()
    assert tckpt.search_max_iteration(str(d)) is jckpt.search_max_iteration(str(d)) is None
    for name in ("iteration_5", "iteration_40", "iteration_7.tmp", "notes", "iteration_x"):
        (d / name).mkdir()
    assert tckpt.search_max_iteration(str(d)) == jckpt.search_max_iteration(str(d)) == 40


def test_nothing_to_resume(states, tmp_path):
    assert tckpt.load_train_state(str(tmp_path / "none"), states["port"]) == (None, 0)


@pytest.mark.parametrize("change", ["shape", "dtype", "missing leaf", "extra leaf"])
def test_template_mismatch_raises(states, tmp_path, change):
    s = states["port"]
    d = str(tmp_path / "trained_model")
    tckpt.save_train_state(d, 1, s)
    g = s.params.gaussians
    if change == "shape":
        tpl = dataclasses.replace(s, params=dataclasses.replace(s.params, gaussians=dataclasses.replace(
            g, semantic=torch.zeros((g.semantic.shape[0], 3)))))
        leaf = "params.gaussians.semantic"
    elif change == "dtype":
        tpl = dataclasses.replace(s, aux=dataclasses.replace(s.aux, denom=s.aux.denom.double()))
        leaf = "aux.denom"
    elif change == "missing leaf":  # the template has no sky: the file's sky leaves are unexpected
        p = dataclasses.replace(s.params, sky=None)
        adam = s.adam._replace(**{m: {k: v for k, v in getattr(s.adam, m).items() if not k.startswith("sky.")}
                                  for m in ("mu", "nu", "count")})
        tpl = dataclasses.replace(s, params=p, adam=adam)
        leaf = "params.sky.cubemap"
    else:  # the template has a leaf the file lacks
        adam = s.adam._replace(mu={**s.adam.mu, "extra.leaf": torch.zeros(3)})
        tpl = dataclasses.replace(s, adam=adam)
        leaf = "adam.mu.extra.leaf"
    with pytest.raises(ValueError, match=leaf.replace(".", r"\.")):
        tckpt.load_train_state(d, tpl)


def test_resume_restores_the_step(states, tmp_path):
    """(tests/test_checkpoint.py::test_resume_continues_training)"""
    s = dataclasses.replace(states["port"], step=5)
    d = str(tmp_path / "resume")
    tckpt.save_train_state(d, 5, s)
    restored, it = tckpt.load_train_state(d, s)
    assert it == 5 and restored.step == 5


def test_ply_is_byte_equal_to_jax(states, tmp_path):
    js, ts = states["jax"], states["port"]
    want = jckpt.save_point_cloud(str(tmp_path / "jax"), 7, js.params.gaussians, js.aux, states["jtable"])
    got = tckpt.save_point_cloud(str(tmp_path / "port"), 7, ts.params.gaussians, ts.aux, states["table"])
    assert got.endswith(os.path.join("iteration_7", "point_cloud.ply"))
    assert os.path.getsize(got) > 10_000
    assert filecmp.cmp(got, want, shallow=False)


def test_load_point_cloud_into_equals_jax(states, tmp_path):
    js, ts = states["jax"], states["port"]
    path = jckpt.save_point_cloud(str(tmp_path / "pc"), 7, js.params.gaussians, js.aux, states["jtable"])
    jp, jaux = jckpt.load_point_cloud_into(path, jax.tree.map(jnp.zeros_like, js.params.gaussians), js.aux,
                                           states["jtable"])
    blank = dataclasses.replace(ts.params.gaussians, **{
        f.name: torch.zeros_like(getattr(ts.params.gaussians, f.name))
        for f in dataclasses.fields(ts.params.gaussians)})
    tp, taux = tckpt.load_point_cloud_into(path, blank, ts.aux, states["table"])
    for f in dataclasses.fields(tp):
        np.testing.assert_array_equal(getattr(tp, f.name).numpy(), np.asarray(getattr(jp, f.name)), err_msg=f.name)
    np.testing.assert_array_equal(taux.alive.numpy(), np.asarray(jaux.alive))
    assert int(taux.alive.sum()) == int(np.asarray(js.aux.alive).sum()) > 100


def test_scene_artifacts_equal_jax(tmp_path):
    """input.ply and cameras.json of a loaded Waymo-format sequence."""
    root = str(tmp_path / "seq")
    write_synthetic_waymo(root, num_frames=3, cameras=(0, 1))
    out = {}
    for pkg, default_config, build, save in (
        ("jax", j_default_config, jrunner.build_scene, jrunner.save_scene_artifacts),
        ("port", t_default_config, lambda c: trunner.build_scene(c, device="cpu"), trunner.save_scene_artifacts),
    ):
        cfg = default_config()
        cfg.source_path, cfg.model_path, cfg.mode = root, str(tmp_path / pkg), "train"
        cfg.data.type, cfg.data.cameras, cfg.data.split_train, cfg.data.split_test = "Waymo", [0, 1], -1, 2
        os.makedirs(cfg.model_path)
        np.random.seed(0)
        save(cfg, build(cfg))
        out[pkg] = cfg.model_path
    assert filecmp.cmp(os.path.join(out["port"], "input.ply"), os.path.join(out["jax"], "input.ply"), shallow=False)
    with open(os.path.join(out["port"], "cameras.json")) as f:
        got = json.load(f)
    with open(os.path.join(out["jax"], "cameras.json")) as f:
        want = json.load(f)
    assert len(got) == 6 and got == want


def test_checkpoint_holds_every_leaf(states):
    flat = tckpt.state_to_flat(states["port"])
    params = flatten_params(states["port"].params)
    assert {f"params.{k}" for k in params} | {f"adam.{m}.{k}" for m in ("mu", "nu", "count") for k in params} \
        | {f"aux.{f.name}" for f in dataclasses.fields(states["port"].aux)} | {"step"} == set(flat)
