"""The scene generator: reproducible from a seed, the configurations'
published shapes."""

from __future__ import annotations

import json
import os
import types

import pytest
import torch

from conftest import ROOT, toy_cell
from benchmark.harness import scene as S


def _config(name):
    with open(os.path.join(ROOT, "benchmark", "configs", f"{name}.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("name,views,train,size", [
    ("waymo_train_002", 303, 303, (1600, 1067)),
    ("waymo_val_006", 86, 64, (1600, 1067)),
])
def test_published_shapes(name, views, train, size):
    cfg = _config(name)
    W, H, K, vs, tv = S.make_views(cfg["scene"])
    assert (W, H) == size and len(vs) == views and len(tv) == train
    assert abs(K[0, 0] - 2070.0 * 1600 / 1920) < 1e-9
    r = cfg["recipe"]
    assert r["model"]["gaussian"]["sh_degree"] == cfg["scene"]["sh_degree"] == 1
    assert r["model"]["gaussian"]["fourier_dim"] == cfg["scene"]["fourier_dim"] == 5
    assert r["model"]["nsg"]["include_sky"] == cfg["scene"]["include_sky"]
    rows = cfg["scene"]["rows"]
    alive = rows["background_alive"] + cfg["scene"]["actors"] * rows["actor_alive"]
    assert abs(alive - 2**20) / 2**20 < 0.02


def test_same_seed_same_scene_other_seed_other_scene():
    cfg = toy_cell("waymo_train_002", "train_densify").config["scene"]
    a = S.make_scene(cfg, 2**31 + 7, "cpu")
    b = S.make_scene(cfg, 2**31 + 7, "cpu")
    c = S.make_scene(cfg, 2**31 + 8, "cpu")
    for f in ("xyz", "feat_dc", "feat_rest", "log_scale", "rot", "opacity_logit", "sky_cubemap", "opt_trans"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert not torch.equal(a.xyz, c.xyz)
    assert int(a.alive.sum()) == int(c.alive.sum())  # the same sizes for every seed
    ta = S.make_truth(a, a.views[0], "cpu")
    tb = S.make_truth(b, b.views[0], "cpu")
    assert torch.equal(ta.image, tb.image) and torch.equal(ta.lidar_depth, tb.lidar_depth)


def test_truth_has_the_structure_of_a_street_image():
    cfg = toy_cell("waymo_train_002", "train_densify", width=320).config["scene"]
    sc = S.make_scene(cfg, 11, "cpu")
    t = S.make_truth(sc, sc.views[0], "cpu")
    sky = t.sky_mask[..., 0]
    H = sky.shape[0]
    # sky above, ground below, LiDAR returns only where a surface is hit
    assert sky[: H // 4].float().mean() > 0.3 and sky[3 * H // 4:].float().mean() < 0.01
    assert (t.lidar_depth[sky] == 0).all() and (t.lidar_depth > 0).any()
    assert t.image.min() >= 0 and t.image.max() <= 1 and t.image.std() > 0.05


def test_feed_visits_every_training_view_once_an_epoch():
    from benchmark.harness.loops import Feed

    f = Feed(list(range(10, 40)), seed=5)
    first = [f.next() for _ in range(30)]
    assert sorted(first) == list(range(10, 40))
    g = Feed(list(range(10, 40)), seed=5)
    assert [g.next() for _ in range(30)] == first


@pytest.mark.parametrize("which", ["all", "train", "test"])
def test_served_views_select_and_keep_frame_order(which):
    from benchmark.harness.loops import served_views

    _, _, _, views, train_views = S.make_views(_config("waymo_val_006")["scene"])
    scene = types.SimpleNamespace(views=views, train_views=train_views)
    v = served_views(scene, which)
    train = set(scene.train_views)
    assert v == sorted(v) and len(v) > 0
    assert {"all": len(v) == len(scene.views), "train": set(v) == train,
            "test": not (set(v) & train) and len(v) == len(scene.views) - len(train)}[which]
