"""The port's LPIPS (street_gaussians_torch/utils/lpips.py) against the JAX
package's, on weights made from a seed (chip_smoke.lpips_seeded_weights,
tests/test_lpips.py's recipe for both nets: the calibrated weights are
not in the repository), as tests/test_lpips.py and
tests/test_lpips_loading.py hold the JAX one; and runner.evaluate_metrics
with and without weights against the JAX function.

Tolerances: LPIPS values rtol 1e-5 (float32 convolutions summed in
another order by torch and by XLA; the value is a mean of many
products); 0 exactly for identical images; the loaders' arrays equal.
"""

import os

import numpy as np
import pytest
import torch

from chip_smoke import lpips_seeded_weights
from street_gaussians_torch import runner as trunner
from street_gaussians_torch.config import load_config as t_load_config
from street_gaussians_torch.utils import lpips as TL
from street_gaussians_torch.utils.image_io import imwrite
from street_gaussians_tpu import runner as jrunner
from street_gaussians_tpu.config import load_config as j_load_config
from street_gaussians_tpu.utils import lpips as JL
from test_torch_runner import draw_free_overrides, one_thread, small_sensors, write_sequence  # noqa: F401

RTOL = 1e-5


def images(seed, H, W):
    rng = np.random.default_rng(seed)
    pred = rng.random((H, W, 3)).astype(np.float32)
    gt = np.clip(pred + 0.1 * rng.standard_normal(pred.shape), 0, 1).astype(np.float32)
    return pred, gt


@pytest.mark.parametrize("net_type,H,W", [("alex", 64, 96), ("vgg", 48, 64)])
def test_lpips_matches_jax(net_type, H, W):
    """AlexNet and VGG16 on weights from a seed, numpy and tensor inputs."""
    weights = lpips_seeded_weights(net_type, 0)
    pred, gt = images(1, H, W)
    want = float(JL.lpips_from_weights(pred, gt, weights, net_type))
    got = TL.lpips_from_weights(torch.as_tensor(pred), torch.as_tensor(gt), weights, net_type)
    assert got.shape == () and got.device.type == "cpu"
    np.testing.assert_allclose(float(got), want, rtol=RTOL)
    np.testing.assert_allclose(float(TL.lpips_from_weights(pred, gt, weights, net_type)), want, rtol=RTOL)
    assert want > 0


@pytest.mark.parametrize("net_type", ["alex", "vgg"])
def test_lpips_zero_for_identical_images(net_type):
    weights = lpips_seeded_weights(net_type, 2)
    img = torch.as_tensor(images(3, 32, 48)[0])
    assert float(TL.lpips_from_weights(img, img, weights, net_type)) == 0.0


@pytest.fixture
def fake_hub(tmp_path, monkeypatch):
    """An empty torch hub cache, no $SGTPU_LPIPS_WEIGHTS, cleared caches,
    in both packages."""
    hub = tmp_path / "hub"
    hub.mkdir()
    for mod in (TL, JL):
        monkeypatch.setattr(mod, "_hub_dir", lambda: str(hub))
        monkeypatch.setattr(mod, "_cache", {})
    monkeypatch.delenv("SGTPU_LPIPS_WEIGHTS", raising=False)
    return hub


def test_lpips_none_without_weights(fake_hub):
    img = np.zeros((8, 8, 3), np.float32)
    assert TL.lpips(img, img) is None and TL.load_weights("vgg") is None
    assert JL.lpips(img, img) is None


def _torchvision_and_lin(weights, scheme):
    """The weights as a torchvision backbone state dict (features.<idx>)
    and an LPIPS lin state dict in one of the two published schemes."""
    idx = (0, 3, 6, 8, 10)  # alexnet().features' convs
    backbone = {f"features.{j}.{p}": torch.as_tensor(weights[f"conv{i}.{p}"])
                for i, j in enumerate(idx) for p in ("weight", "bias")}
    backbone["classifier.1.weight"] = torch.zeros(8, 8)  # ignored by the loader
    lin = {(f"lin{li}.model.1.weight" if scheme == "wrapped" else f"{li}.1.weight"): torch.as_tensor(
        weights[f"lin{li}.weight"]) for li in range(5)}
    return backbone, lin


@pytest.mark.parametrize("scheme,lin_name", [("wrapped", "alex.pth"), ("bare", "lpips_alex.pth")])
def test_load_torch_hub_both_naming_schemes(fake_hub, scheme, lin_name):
    """Fake .pth files in the hub cache under both naming schemes load
    to the same arrays as the JAX loader's, and give JAX's value."""
    weights = lpips_seeded_weights("alex", 4)
    backbone, lin = _torchvision_and_lin(weights, scheme)
    torch.save(backbone, fake_hub / "alexnet-owt-7be5be79.pth")
    torch.save(lin, fake_hub / lin_name)
    got, want = TL.load_weights("alex"), JL.load_weights("alex")
    assert got is not None and set(got) == set(want) == set(weights)
    for k in weights:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        np.testing.assert_array_equal(got[k], weights[k], err_msg=k)
    pred, gt = images(5, 64, 64)
    np.testing.assert_allclose(TL.lpips(torch.as_tensor(pred), torch.as_tensor(gt)), JL.lpips(pred, gt), rtol=RTOL)
    assert TL.lpips(pred, pred) == 0.0


def test_load_npz_from_env(fake_hub, tmp_path, monkeypatch):
    """$SGTPU_LPIPS_WEIGHTS: an .npz with <net>.-prefixed keys, both nets."""
    weights = {"alex": lpips_seeded_weights("alex", 6), "vgg": lpips_seeded_weights("vgg", 7)}
    path = str(tmp_path / "lpips_weights.npz")
    np.savez(path, **{f"{n}.{k}": v for n, w in weights.items() for k, v in w.items()})
    monkeypatch.setenv("SGTPU_LPIPS_WEIGHTS", path)
    for n, w in weights.items():
        got = TL.load_weights(n)
        assert set(got) == set(w)
        for k in w:
            np.testing.assert_array_equal(got[k], w[k], err_msg=f"{n} {k}")


@pytest.mark.parametrize("with_weights", [False, True])
def test_evaluate_metrics_matches_jax(fake_hub, tmp_path, monkeypatch, capsys, with_weights):
    """evaluate_metrics over saved renders (noise images) of a miniature
    sequence: without weights PSNR and SSIM alone (and a line that says
    so); with weights from $SGTPU_LPIPS_WEIGHTS also a per-view lpips and
    the split's mean, as the JAX function gives them."""
    if with_weights:
        path = str(tmp_path / "w.npz")
        np.savez(path, **{f"alex.{k}": v for k, v in lpips_seeded_weights("alex", 8).items()})
        monkeypatch.setenv("SGTPU_LPIPS_WEIGHTS", path)
    root = str(tmp_path / "seq")
    write_sequence(root, num_frames=2)
    opts = draw_free_overrides(root, str(tmp_path / "out"), 10)
    tcfg, jcfg = t_load_config(None, opts, "evaluate"), j_load_config(None, opts, "evaluate")
    scene = trunner.build_scene(tcfg, device="cpu")
    rng = np.random.default_rng(9)
    split_dir = os.path.join(tcfg.model_path, "train_renders")
    os.makedirs(split_dir)
    for v in scene.train_views:
        imwrite(os.path.join(split_dir, f"{v.image_name}_rgb.png"),
                rng.integers(0, 256, (v.frame_input.cam.H, v.frame_input.cam.W, 3), dtype=np.uint8))
    got = trunner.evaluate_metrics(tcfg, device="cpu")
    assert ("no LPIPS weights found" in capsys.readouterr().out) != with_weights
    want = jrunner.evaluate_metrics(jcfg)
    keys = {"psnr", "ssim", "per_view"} | ({"lpips"} if with_weights else set())
    assert set(got["train"]) == set(want["train"]) == keys
    assert len(got["train"]["per_view"]) == len(scene.train_views) == 2
    for g, w in zip(got["train"]["per_view"], want["train"]["per_view"]):
        assert g["name"] == w["name"] and set(g) == set(w)
        np.testing.assert_allclose(g["psnr"], w["psnr"], rtol=1e-5)
        if with_weights:
            np.testing.assert_allclose(g["lpips"], w["lpips"], rtol=RTOL)
    if with_weights:
        np.testing.assert_allclose(got["train"]["lpips"], want["train"]["lpips"], rtol=RTOL)
