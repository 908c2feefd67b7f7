"""The port's gradient sky heuristic
(street_gaussians_torch/script/waymo/generate_sky_mask.py: scipy's
grey_dilation / grey_erosion with mode="nearest" and an 8-connected
label) against the repo's root script (cv2.morphologyEx's closing, whose
border never erodes or dilates, and cv2.connectedComponents), pixel for
pixel: random images, a sky band touching the top rows and both side
borders, thin gaps the 7x7 closing bridges, components that touch only
diagonally, images under 20 rows (the top band is then one row); and
the CLI on a directory. The JAX script is imported from script/waymo/
(numpy and cv2 only)."""

import importlib.util
import os

import cv2
import numpy as np
import pytest

from street_gaussians_torch.script.waymo import generate_sky_mask as t_sky

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location("root_generate_sky_mask",
                                               os.path.join(REPO, "script", "waymo", "generate_sky_mask.py"))
j_sky = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(j_sky)

SKY = np.array([235, 206, 135], np.uint8)  # BGR, bright and blue-ish
GROUND = np.array([40, 42, 45], np.uint8)


def from_mask(sky: np.ndarray) -> np.ndarray:
    return np.where(sky[..., None], SKY, GROUND).astype(np.uint8)


def random_image(seed: int):
    rng = np.random.default_rng(seed)
    H, W = rng.integers(20, 90, 2)
    img = rng.integers(0, 256, (H, W, 3)).astype(np.uint8)
    # a mix of colours around the thresholds (brightness 110 / 200, b vs r - 10)
    keep = rng.random((H, W)) < 0.5
    return np.where(keep[..., None], img, from_mask(rng.random((H, W)) < 0.6))


def band_touching_borders():
    sky = np.zeros((60, 80), bool)
    sky[:25] = True  # the top rows, across both side borders
    sky[25:45, :3] = True  # down the left border
    sky[25:50, -2:] = True  # down the right border
    sky[40:44, 30:40] = True  # an island away from the top
    return from_mask(sky)


def thin_gaps():
    sky = np.zeros((64, 96), bool)
    sky[:10] = True
    for k, gap in enumerate((1, 2, 3, 5, 6, 7, 8)):
        x = 4 + 13 * k
        sky[10 + gap:40, x:x + 6] = True  # columns cut from the band by `gap` rows
        sky[45:60, x:x + 2] = True
        sky[45:60, x + 2 + gap:x + 6 + gap] = True  # and two slivers `gap` apart
    return from_mask(sky)


def diagonal_contacts():
    """Squares 10 px wide chained corner to corner down from the top rows:
    the closing fills nothing at a corner where two squares meet, so only
    8-connectivity joins them to the top."""
    sky = np.zeros((64, 64), bool)
    for k in range(5):
        sky[10 * k: 10 * k + 10, 10 * k: 10 * k + 10] = True
    return from_mask(sky)


def short_image(h: int):
    rng = np.random.default_rng(h)
    return from_mask(rng.random((h, 40)) < 0.5)


CASES = {
    **{f"random_{s}": (lambda s=s: random_image(s)) for s in range(3)},
    "band_touching_borders": band_touching_borders,
    "thin_gaps": thin_gaps,
    "diagonal_contacts": diagonal_contacts,
    **{f"short_{h}": (lambda h=h: short_image(h)) for h in (1, 7, 19)},
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_gradient_sky_mask_matches_cv2(case):
    img = CASES[case]()
    want = j_sky.gradient_sky_mask(img)
    got = t_sky.gradient_sky_mask(img)
    assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    if case == "band_touching_borders":
        assert want[0].all() and want[:, 0].sum() > 40 and not want[40:44, 30:40].any()
    if case == "diagonal_contacts":
        assert want[45, 45] == 255  # the last square, joined through four corners


def test_scipy_border_rule_differs_from_binary_closing():
    """scipy's binary_closing erodes from a zero border (border_value=0)
    and so eats the frame where sky meets the image's edge; the port's
    grey closing with mode="nearest" keeps it, as cv2 does."""
    from scipy import ndimage

    cand = np.ones((20, 30), np.uint8)
    eaten = ndimage.binary_closing(cand, structure=np.ones((7, 7)))
    assert not eaten[0].any()
    img = from_mask(cand.astype(bool))
    assert t_sky.gradient_sky_mask(img).all() and j_sky.gradient_sky_mask(img).all()


def test_cli_on_a_directory(tmp_path):
    seq = tmp_path / "seq"
    (seq / "images").mkdir(parents=True)
    imgs = {"000000_0.png": band_touching_borders(), "000000_1.png": thin_gaps(), "000001_0.jpg": random_image(5)}
    for n, img in imgs.items():
        cv2.imwrite(str(seq / "images" / n), img)
    out = t_sky.main(["--datadir", str(seq)])
    assert out["images"] == 3
    assert sorted(os.listdir(seq / "sky_mask")) == ["000000_0.png", "000000_1.png", "000001_0.png"]
    for n in imgs:
        got = cv2.imread(str(seq / "sky_mask" / (n.split(".")[0] + ".png")), cv2.IMREAD_UNCHANGED)
        np.testing.assert_array_equal(got, j_sky.gradient_sky_mask(cv2.imread(str(seq / "images" / n))))
    with pytest.raises(NotImplementedError, match="model.onnx"):
        t_sky.main(["--datadir", str(seq), "--backend", "onnx", "--onnx_model", "model.onnx"])
