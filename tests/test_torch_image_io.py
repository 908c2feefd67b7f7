"""The port's cv2-free image code (street_gaussians_torch/utils/image_io.py)
against OpenCV, and the port's imports.

Tolerances: decoded PNG pixels, uint8 and bool resizes, the nearest
resize and fill_poly's masks are equal exactly; float32 area resizes
within 1e-6 (cv2 sums the same float32 products in the same order;
observed equal).
"""

import os
import re
import struct
import zlib

import cv2
import numpy as np
import pytest

from street_gaussians_torch.utils import image_io
from street_gaussians_torch.utils.box import bbox_to_corner3d, get_bound_2d_mask

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FACES = ([0, 1, 3, 2, 0], [4, 5, 7, 6, 5], [0, 1, 5, 4, 0], [2, 3, 7, 6, 2], [0, 2, 6, 4, 0], [1, 3, 7, 5, 1])


# ---------------------------------------------------------------- PNG


def _png_bytes(px: np.ndarray, ctype: int, filt: int, depth: int = 8, interlace: int = 0) -> bytes:
    """A PNG of the samples px [H, W, C] (file order) with every row
    under filter `filt` (0-4), encoded from the PNG specification."""
    H, W, C = px.shape
    raw = px.reshape(H, W * C).astype(np.int32)
    rows = []
    for y in range(H):
        row, up = raw[y], raw[y - 1] if y else np.zeros_like(raw[0])
        left = np.concatenate([np.zeros(C, np.int32), row[:-C]])
        ul = np.concatenate([np.zeros(C, np.int32), up[:-C]])
        if filt == 0:
            f = row
        elif filt == 1:
            f = row - left
        elif filt == 2:
            f = row - up
        elif filt == 3:
            f = row - (left + up) // 2
        else:
            p = left + up - ul
            pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - ul)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, ul))
            f = row - pred
        rows.append(bytes([filt]) + (f & 0xFF).astype(np.uint8).tobytes())

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))

    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, depth, ctype, 0, 0, interlace))
            + chunk(b"IDAT", zlib.compress(b"".join(rows))) + chunk(b"IEND", b""))


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_imread_matches_cv2_on_cv2_pngs(tmp_path, channels):
    """Gray, BGR and BGRA PNGs written by cv2 (every row filter Sub),
    read in colour and unchanged."""
    rng = np.random.default_rng(channels)
    shape = (37, 53) if channels == 1 else (37, 53, channels)
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    img[:5, :7] = 17  # a flat patch
    path = str(tmp_path / "a.png")
    cv2.imwrite(path, img)
    np.testing.assert_array_equal(image_io.imread(path), cv2.imread(path))
    np.testing.assert_array_equal(image_io.imread(path, unchanged=True), cv2.imread(path, cv2.IMREAD_UNCHANGED))
    np.testing.assert_array_equal(image_io.imread(path, unchanged=True), img)


@pytest.mark.parametrize("filt", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("ctype", [0, 2, 4, 6])
def test_imread_undoes_every_filter(tmp_path, filt, ctype):
    """Hand-made PNGs of each filter (0 None, 1 Sub, 2 Up, 3 Average, 4
    Paeth) and colour type (gray, RGB, gray + alpha, RGBA), against
    cv2's decoder."""
    C = {0: 1, 2: 3, 4: 2, 6: 4}[ctype]
    rng = np.random.default_rng(10 * filt + ctype)
    px = rng.integers(0, 256, (9, 11, C), dtype=np.uint8)
    px[3] = px[2]  # repeated rows and a smooth ramp: small residuals
    px[5] = np.arange(11, dtype=np.uint8)[:, None] * 20
    path = str(tmp_path / "f.png")
    with open(path, "wb") as f:
        f.write(_png_bytes(px, ctype, filt))
    np.testing.assert_array_equal(image_io.imread(path), cv2.imread(path))
    np.testing.assert_array_equal(image_io.imread(path, unchanged=True), cv2.imread(path, cv2.IMREAD_UNCHANGED))


@pytest.mark.parametrize("what, kw", [("interlaced", dict(interlace=1)), ("colour type 3", dict(ctype=3)),
                                      ("16-bit", dict(depth=16))])
def test_imread_refuses_unsupported_pngs(tmp_path, what, kw):
    """Interlaced, palette and 16-bit PNGs raise a ValueError naming the
    file."""
    px = np.zeros((4, 4, 1), np.uint8)
    path = str(tmp_path / f"bad_{what.replace(' ', '_')}.png")
    args = dict(ctype=0, filt=0)
    args.update(kw)
    with open(path, "wb") as f:
        f.write(_png_bytes(px, args.pop("ctype"), args.pop("filt"), **args))
    with pytest.raises(ValueError, match=re.escape(path)):
        image_io.imread(path)


@pytest.mark.parametrize("shape", [(23, 31), (23, 31, 3), (1, 1, 3), (1, 1)])
def test_imwrite_round_trips(tmp_path, shape):
    """imwrite then imread (and cv2.imread) give the image back."""
    img = np.random.default_rng(len(shape)).integers(0, 256, shape, dtype=np.uint8)
    path = str(tmp_path / "w.png")
    image_io.imwrite(path, img)
    np.testing.assert_array_equal(image_io.imread(path, unchanged=True), img)
    np.testing.assert_array_equal(cv2.imread(path, cv2.IMREAD_UNCHANGED), img)


def test_non_png_goes_through_cv2(tmp_path):
    """A JPEG is read by cv2 (imported when it is needed)."""
    img = np.random.default_rng(0).integers(0, 256, (16, 24, 3), dtype=np.uint8)
    path = str(tmp_path / "a.jpg")
    cv2.imwrite(path, img)
    np.testing.assert_array_equal(image_io.imread(path), cv2.imread(path))


# ---------------------------------------------------------------- resizing


@pytest.mark.parametrize("src, dst", [
    ((1280, 1920), (1067, 1600)), ((886, 1920), (738, 1600)), ((37, 53), (23, 31)),
    # integer factors: cv2's block mean (a 3200-wide sensor under the
    # 1600 px cap; 2 x 2 with a 1-channel row tail; 3 x 2; 1 x 5)
    ((2400, 3200), (1200, 1600)), ((14, 38), (7, 19)), ((21, 30), (7, 15)), ((9, 35), (9, 7))])
def test_resizes_match_cv2(src, dst):
    """resize_area and resize_nearest against cv2 at the loaders' width
    cap (Waymo's 1920-wide sensors), odd sizes and integer factors: uint8 and float32
    colour images, a one-channel float32 map and a bool mask."""
    rng = np.random.default_rng(src[0])
    (h, w), (H, W) = src, dst
    u8 = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    f32 = rng.uniform(0, 1, (h, w, 3)).astype(np.float32)
    depth = np.where(rng.uniform(size=(h, w)) < 0.1, rng.uniform(2, 30, (h, w)), 0).astype(np.float32)
    mask = rng.uniform(size=(h, w)) < 0.3
    np.testing.assert_array_equal(image_io.resize_area(u8, (W, H)), cv2.resize(u8, (W, H), interpolation=cv2.INTER_AREA))
    for a in (f32, depth):
        np.testing.assert_allclose(image_io.resize_area(a, (W, H)), cv2.resize(a, (W, H), interpolation=cv2.INTER_AREA),
                                   rtol=0, atol=1e-6)
    for a in (u8, f32, depth):
        np.testing.assert_array_equal(image_io.resize_nearest(a, (W, H)),
                                      cv2.resize(a, (W, H), interpolation=cv2.INTER_NEAREST))
    want = cv2.resize(mask.astype(np.uint8), (W, H), interpolation=cv2.INTER_NEAREST).astype(bool)
    np.testing.assert_array_equal(image_io.resize_nearest(mask, (W, H)), want)


# ---------------------------------------------------------------- polygons


def _random_faces(rng, n_boxes):
    """The 6 closed faces of n_boxes random boxes projected by random
    cameras, as get_bound_2d_mask projects them: boxes in front of,
    beside and behind the camera (depth clipped to 1e-3, so vertices
    land far off the image). Yields (H, W, [5, 2] int vertices)."""
    for i in range(n_boxes):
        H, W = (64, 96) if i % 3 == 0 else (int(rng.integers(8, 160)), int(rng.integers(8, 240)))
        f = rng.uniform(0.5, 2.0) * W
        K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]])
        half = rng.uniform(0.3, 3.0, 3)
        corners = bbox_to_corner3d(np.stack([-half, half]))
        th = rng.uniform(0, 2 * np.pi)
        R = np.array([[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0], [0, 0, 1]])
        p = corners @ R.T + [rng.uniform(-15, 15), rng.uniform(-3, 3), rng.uniform(-8, 40)]
        p[:, 2] = np.clip(p[:, 2], 1e-3, None)
        q = p @ K.T
        uv = np.round(q[:, :2] / q[:, 2:]).astype(int)
        for face in FACES:
            yield H, W, uv[face]


def test_fill_poly_matches_cv2():
    """fill_poly against cv2.fillPoly on 1,040 faces: 900 projected box
    faces (vertices off the image, degenerate faces), 120 random closed
    pentagons, some self-intersecting, some far off the image, and 20
    random quads on Waymo's 1280x1920 (edges of ~1,000 rows, where a
    16-bit fixed-point slope would drift by a pixel's rounding)."""
    rng = np.random.default_rng(0)
    cases = list(_random_faces(rng, 150))
    for i in range(120):
        H, W = int(rng.integers(5, 80)), int(rng.integers(5, 80))
        s = (1.0, 3.0, 50.0)[i % 3]
        pts = np.stack([rng.integers(-s * W, s * W + 1, 5), rng.integers(-s * H, s * H + 1, 5)], axis=1)
        pts[4] = pts[0]
        cases.append((H, W, pts))
    for _ in range(20):
        pts = np.stack([rng.integers(-400, 2300, 4), rng.integers(-300, 1600, 4)], axis=1)
        cases.append((1280, 1920, pts))
    filled = clipped = 0
    for H, W, pts in cases:
        want = np.zeros((H, W), np.uint8)
        cv2.fillPoly(want, [pts.astype(np.int32)], 1)
        got = image_io.fill_poly(np.zeros((H, W), np.uint8), pts, 1)
        np.testing.assert_array_equal(got, want, err_msg=f"{H}x{W} {pts.tolist()}")
        filled += int(want.sum())
        clipped += bool(want.any()) and not ((pts >= 0) & (pts < [W, H])).all()
    assert len(cases) == 1040 and filled > 5_000_000 and clipped > 100


def test_bound_2d_mask_matches_cv2_reference():
    """get_bound_2d_mask (the obj_bound masks of the Waymo loader) against
    the same projection filled by cv2.fillPoly, on boxes in front of the
    camera."""
    rng = np.random.default_rng(1)
    H, W = 64, 96
    K = np.array([[80.0, 0, 48], [0, 80.0, 32], [0, 0, 1]])
    for _ in range(40):
        half = rng.uniform(0.5, 2.5, 3)
        corners = bbox_to_corner3d(np.stack([-half, half]))
        pose = np.eye(4)
        pose[:3, 3] = [rng.uniform(-4, 4), rng.uniform(-2, 2), rng.uniform(4, 30)]
        got = get_bound_2d_mask(corners.copy(), K, pose, H, W)
        c = corners @ pose[:3, :3].T + pose[:3, 3]
        q = c @ K.T
        uv = np.round(q[:, :2] / q[:, 2:]).astype(int)
        want = np.zeros((H, W), np.uint8)
        for face in FACES:
            cv2.fillPoly(want, [uv[face].astype(np.int32)], 1)
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------- imports


def test_port_imports_no_jax_and_no_top_level_cv2_or_yaml():
    """No module of the port (nor chip_smoke.py) imports jax, the JAX
    package, orbax or yaml anywhere (the port reads and writes its YAML
    configs itself and saves torch checkpoints), nor cv2 at module level
    (the card's machine is not known to have it: image_io imports it
    inside the functions that read non-PNG images; visualize.py inside
    write_video). The modules of the config, checkpoint, runner and CLI
    slice, visualize.py, utils/lpips.py, make_ply.py, the oracle, the
    single-cloud renderer, utils/semantics.py and the demo-scene scripts
    are among those checked."""
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "street_gaussians_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    anywhere = re.compile(r"^\s*(import|from)\s+(jax|street_gaussians_tpu|orbax|yaml)\b")
    top_level = re.compile(r"^(import|from)\s+cv2\b")
    bad = []
    for path in files:
        with open(path) as f:
            for n, line in enumerate(f, 1):
                if anywhere.match(line) or top_level.match(line):
                    bad.append(f"{os.path.relpath(path, REPO)}:{n}: {line.strip()}")
    names = {os.path.relpath(p, REPO) for p in files}
    slice_modules = {f"street_gaussians_torch/{m}.py" for m in (
        "config", "checkpoint", "runner", "train", "render", "metrics", "utils/yaml_subset", "visualize",
        "utils/lpips", "make_ply", "utils/semantics", "ops/reference_rasterizer", "models/simple_renderer",
        "script/make_demo_scene", "script/run_eval_heldout")}
    assert slice_modules <= names, slice_modules - names
    assert len(files) > 40 and not bad, bad
