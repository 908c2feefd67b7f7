"""Image reading, writing, resizing and polygon filling without OpenCV.

Takes the place of the cv2 calls of the JAX package's loaders
(street_gaussians_tpu/data/dataset.py, data/waymo.py, data/static_readers.py,
data/synthetic_waymo.py and utils/box.py) and of the repo's root
data-preparation scripts (script/waymo/, script/kitti/), with the same
results:

* imread / imwrite / imdecode: 8-bit PNG (gray, gray + alpha, RGB,
  RGBA, not interlaced) decoded and encoded with zlib, in cv2's BGR
  channel order, from a file or (imdecode) from bytes in memory; image_size
  reads a PNG's size off its header. Other formats (the JPEGs of a Colmap
  scene or of a Waymo segment) go through cv2, imported when such an
  image is read, so they need OpenCV installed.
* resize_area: cv2.resize(..., INTER_AREA) for a shrink: each output
  pixel is the overlap-weighted mean of the source pixels its footprint
  covers (a block mean when both factors are integers), summed in
  float32 in cv2's order.
* resize_nearest: cv2.resize(..., INTER_NEAREST): source index
  floor(dst * (1 / (dst_size / src_size))), clipped.
* fill_poly: cv2.fillPoly(mask, [pts], value) with integer vertices
  (8-connected outline plus an even-odd scanline fill in 16.16 fixed
  point, vertices off the image clipped as cv2 clips them).

All host-side numpy.
"""

from __future__ import annotations

import math
import struct
import zlib

import numpy as np

_PNG_SIG = b"\x89PNG\r\n\x1a\n"
# PNG colour type -> channels (8-bit samples)
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def _is_png(path: str) -> bool:
    with open(path, "rb") as f:
        return f.read(8) == _PNG_SIG


def _unfilter(raw: np.ndarray, H: int, stride: int, bpp: int, path: str) -> np.ndarray:
    """Undo the PNG row filters: raw [H, 1 + stride] -> [H, stride] uint8.
    Rows of filter 0 (None) and 1 (Sub) do not depend on the row above
    and are undone together; Up is one vectorised step per row; Average
    and Paeth walk their pixels one at a time (cv2 never writes them)."""
    ftype = raw[:, 0]
    data = raw[:, 1:]
    if ftype.max(initial=0) > 4:
        raise ValueError(f"{path}: unknown PNG filter type {int(ftype.max())}")
    out = np.empty((H, stride), np.uint8)
    indep = ftype <= 1
    out[indep] = data[indep]
    sub = ftype == 1
    if sub.any():
        rows = out[sub].reshape(int(sub.sum()), stride // bpp, bpp)
        out[sub] = np.cumsum(rows, axis=1, dtype=np.uint8).reshape(-1, stride)
    if indep.all():
        return out
    prev = np.zeros(stride, np.uint8)
    for y in range(H):
        f = int(ftype[y])
        if f == 2:
            out[y] = data[y] + prev
        elif f == 3:
            row = data[y].astype(np.int32)
            up = prev.astype(np.int32)
            for x in range(stride):
                left = int(row[x - bpp]) if x >= bpp else 0
                row[x] = (row[x] + ((left + int(up[x])) >> 1)) & 0xFF
            out[y] = row
        elif f == 4:
            row = data[y].astype(np.int32)
            up = prev.astype(np.int32)
            for x in range(stride):
                a = int(row[x - bpp]) if x >= bpp else 0
                b = int(up[x])
                c = int(up[x - bpp]) if x >= bpp else 0
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                row[x] = (row[x] + pred) & 0xFF
            out[y] = row
        prev = out[y]
    return out


def _decode_png(path: str) -> np.ndarray:
    """The stored samples, [H, W, channels] uint8 in the file's order
    (gray, gray + alpha, RGB or RGBA)."""
    with open(path, "rb") as f:
        return _decode_png_bytes(f.read(), path)


def _png_header(data: bytes, path: str):
    """IHDR of a PNG: (W, H, depth, colour type, compression, filter,
    interlace)."""
    if data[:8] != _PNG_SIG:
        raise ValueError(f"{path}: not a PNG file")
    if data[12:16] != b"IHDR":
        raise ValueError(f"{path}: PNG without an IHDR chunk first")
    return struct.unpack(">IIBBBBB", data[16:29])


def _decode_png_bytes(data: bytes, path: str) -> np.ndarray:
    """_decode_png of a PNG's bytes; `path` names them in errors."""
    if data[:8] != _PNG_SIG:
        raise ValueError(f"{path}: not a PNG file")
    pos, header, idat = 8, None, []
    while pos + 8 <= len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        kind = data[pos + 4 : pos + 8]
        body = data[pos + 8 : pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: PNG without an IHDR chunk")
    W, H, depth, ctype, _, _, interlace = header
    if interlace != 0:
        raise ValueError(f"{path}: interlaced PNG is not supported")
    if ctype not in _CHANNELS:
        raise ValueError(f"{path}: PNG colour type {ctype} (palette) is not supported")
    if depth != 8:
        raise ValueError(f"{path}: {depth}-bit PNG is not supported (8-bit only)")
    bpp = _CHANNELS[ctype]
    stride = W * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size < H * (stride + 1):
        raise ValueError(f"{path}: truncated PNG image data")
    rows = _unfilter(raw[: H * (stride + 1)].reshape(H, stride + 1), H, stride, bpp, path)
    return rows.reshape(H, W, bpp)


def imread(path: str, unchanged: bool = False) -> np.ndarray:
    """cv2.imread(path) (uint8 [H, W, 3], BGR; gray replicated, alpha
    dropped) or, with unchanged, cv2.imread(path, IMREAD_UNCHANGED)
    (gray [H, W], gray + alpha as BGRA, BGR or BGRA). PNGs are decoded
    here; other formats need cv2."""
    if not _is_png(path):
        try:
            import cv2
        except ImportError as e:
            raise ImportError(f"{path}: reading an image that is not a PNG needs OpenCV (cv2)") from e
        img = cv2.imread(path, cv2.IMREAD_UNCHANGED if unchanged else cv2.IMREAD_COLOR)
        if img is None:
            raise ValueError(f"{path}: cv2 could not read the image")
        return img
    return _to_bgr(_decode_png(path), unchanged)


def _to_bgr(px: np.ndarray, unchanged: bool) -> np.ndarray:
    """Decoded PNG samples in cv2's layout: IMREAD_COLOR (BGR; gray
    replicated, alpha dropped) or, with unchanged, IMREAD_UNCHANGED."""
    c = px.shape[-1]
    if c == 1:
        return px[..., 0] if unchanged else np.repeat(px, 3, axis=-1)
    if c == 2:
        bgr = np.repeat(px[..., :1], 3, axis=-1)
        return np.concatenate([bgr, px[..., 1:]], axis=-1) if unchanged else bgr
    if c == 3:
        return np.ascontiguousarray(px[..., ::-1])
    bgr = px[..., 2::-1]
    return np.ascontiguousarray(np.concatenate([bgr, px[..., 3:]], axis=-1) if unchanged else bgr)


def imdecode(buf: bytes, what: str = "image bytes") -> np.ndarray:
    """cv2.imdecode(np.frombuffer(buf, uint8), IMREAD_COLOR): uint8 [H, W,
    3] BGR. PNG bytes are decoded here, in memory; any other format (the
    JPEG frames of a Waymo segment) goes to cv2, imported then."""
    if bytes(buf[:8]) != _PNG_SIG:
        try:
            import cv2
        except ImportError as e:
            raise ImportError(f"{what}: decoding an image that is not a PNG needs OpenCV (cv2)") from e
        img = cv2.imdecode(np.frombuffer(buf, np.uint8), cv2.IMREAD_COLOR)
        if img is None:
            raise ValueError(f"{what}: cv2 could not decode the image")
        return img
    return _to_bgr(_decode_png_bytes(bytes(buf), what), unchanged=False)


def image_size(path: str):
    """(H, W) of an image file: a PNG's from its header, without decoding
    it; another format's from cv2.imread (imported then)."""
    with open(path, "rb") as f:
        head = f.read(29)
    if head[:8] == _PNG_SIG:
        W, H = _png_header(head, path)[:2]
        return int(H), int(W)
    return imread(path).shape[:2]


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def imwrite(path: str, img: np.ndarray) -> None:
    """cv2.imwrite for PNG: uint8 [H, W] (gray) or [H, W, 3] (BGR); every
    row with filter 1 (Sub), zlib level 1."""
    data = png_bytes(img)
    with open(path, "wb") as f:
        f.write(data)


def png_bytes(img: np.ndarray) -> bytes:
    """The bytes imwrite writes for img (cv2.imencode(".png", img))."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"png_bytes: uint8 images only, got {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    H, W, c = img.shape
    if c not in (1, 3):
        raise ValueError(f"png_bytes: {c} channels (1 or 3)")
    px, ctype = (img[..., ::-1], 2) if c == 3 else (img, 0)
    rows = np.ascontiguousarray(px).reshape(H, W * c)
    sub = rows.copy()
    sub[:, c:] = rows[:, c:] - rows[:, :-c]  # uint8 arithmetic wraps mod 256
    raw = np.concatenate([np.ones((H, 1), np.uint8), sub], axis=1)
    return b"".join([_PNG_SIG, _chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, ctype, 0, 0, 0)),
                     _chunk(b"IDAT", zlib.compress(raw.tobytes(), 1)), _chunk(b"IEND", b"")])


# ---------------------------------------------------------------- resizing


def _area_taps(ssize: int, dsize: int):
    """cv2's area-resize table along one axis (computeResizeAreaTab):
    [dsize, taps] source indices and float32 weights, in cv2's order,
    padded with weight 0."""
    scale = 1.0 / (dsize / ssize)
    rows = []
    for d in range(dsize):
        fs1 = d * scale
        fs2 = fs1 + scale
        cell = min(scale, ssize - fs1)
        s1, s2 = math.ceil(fs1), math.floor(fs2)
        s2 = min(s2, ssize - 1)
        s1 = min(s1, s2)
        taps = []
        if s1 - fs1 > 1e-3:
            taps.append((s1 - 1, (s1 - fs1) / cell))
        taps += [(s, 1.0 / cell) for s in range(s1, s2)]
        if fs2 - s2 > 1e-3:
            taps.append((s2, min(min(fs2 - s2, 1.0), cell) / cell))
        rows.append(taps)
    n = max(len(t) for t in rows)
    idx = np.zeros((dsize, n), np.int64)
    w = np.zeros((dsize, n), np.float32)
    for d, taps in enumerate(rows):
        for k, (s, a) in enumerate(taps):
            idx[d, k], w[d, k] = s, np.float32(a)
    return idx, w


def resize_area(img: np.ndarray, size) -> np.ndarray:
    """cv2.resize(img, (W, H), interpolation=cv2.INTER_AREA) for a shrink:
    uint8 or float32, [h, w] or [h, w, C]. Sums in float32 in cv2's
    order (each row's horizontal taps, then the rows); uint8 rounds half
    to even. Integer factors along both axes take cv2's block mean
    (_resize_area_blocks)."""
    W, H = size
    img = np.asarray(img)
    h, w = img.shape[:2]
    if (W, H) == (w, h):
        return img.copy()
    if W > w or H > h:
        raise ValueError(f"resize_area shrinks only: {w}x{h} -> {W}x{H}")
    if img.dtype not in (np.uint8, np.float32):
        raise ValueError(f"resize_area: uint8 or float32, got {img.dtype}")
    if w % W == 0 and h % H == 0:
        return _resize_area_blocks(img, w // W, h // H)
    x_idx, x_w = _area_taps(w, W)
    y_idx, y_w = _area_taps(h, H)
    src = img.astype(np.float32)
    extra = (1,) * (img.ndim - 2)
    # horizontal: buf[y, d] = ((0 + S[i0] a0) + S[i1] a1) + ...
    buf = np.zeros((h, W) + img.shape[2:], np.float32)
    for k in range(x_idx.shape[1]):
        buf = buf + src[:, x_idx[:, k]] * x_w[:, k].reshape((1, W) + extra)
    # vertical: sum = b0 buf[r0]; sum += b1 buf[r1]; ...
    out = buf[y_idx[:, 0]] * y_w[:, 0].reshape((H, 1) + extra)
    for k in range(1, y_idx.shape[1]):
        out = out + buf[y_idx[:, k]] * y_w[:, k].reshape((H, 1) + extra)
    if img.dtype == np.uint8:
        return np.clip(np.rint(out), 0, 255).astype(np.uint8)
    return out


def _resize_area_blocks(img: np.ndarray, fx: int, fy: int) -> np.ndarray:
    """cv2's INTER_AREA for integer factors (fx, fy): the mean of each
    fy x fx block. The block's taps, row by row, are summed four at a
    time as (((t0 + t1) + t2) + t3), the groups left to right, then
    times float32(1 / (fx fy)); uint8 rounds half to even. 2 x 2 with 1,
    3 or 4 channels is cv2's vector path: uint8 (sum + 2) >> 2, and
    float32 ((t0 + t1) + (t2 + t3)) * 0.25, on one channel only for the
    row's first multiple of 4 outputs (its 4-lane body)."""
    h, w = img.shape[:2]
    H, W = h // fy, w // fx
    cn = img.shape[2] if img.ndim == 3 else 1
    blocks = img.reshape((H, fy, W, fx) + img.shape[2:])
    taps = [blocks[:, dy, :, dx] for dy in range(fy) for dx in range(fx)]
    vector = (fx, fy) == (2, 2) and cn in (1, 3, 4)
    if vector and img.dtype == np.uint8:
        s = sum(t.astype(np.int32) for t in taps)
        return ((s + 2) >> 2).astype(np.uint8)
    taps = [t.astype(np.float32) for t in taps]
    tot = np.zeros(taps[0].shape, np.float32)
    k = 0
    while k + 4 <= len(taps):
        tot = tot + (((taps[k] + taps[k + 1]) + taps[k + 2]) + taps[k + 3])
        k += 4
    for t in taps[k:]:
        tot = tot + t
    out = tot * np.float32(1.0 / (fx * fy))
    if img.dtype == np.uint8:
        return np.clip(np.rint(out), 0, 255).astype(np.uint8)
    if vector and cn != 3:
        body = W if cn == 4 else W - W % 4
        out[:, :body] = ((taps[0] + taps[1]) + (taps[2] + taps[3]))[:, :body] * np.float32(0.25)
    return out


def resize_nearest(img: np.ndarray, size) -> np.ndarray:
    """cv2.resize(img, (W, H), interpolation=cv2.INTER_NEAREST): source
    index floor(dst * (1 / (dst_size / src_size))), clipped to the
    image. Any dtype (bool included)."""
    W, H = size
    img = np.asarray(img)
    h, w = img.shape[:2]
    xi = np.minimum(np.floor(np.arange(W) * (1.0 / (W / w))).astype(np.int64), w - 1)
    yi = np.minimum(np.floor(np.arange(H) * (1.0 / (H / h))).astype(np.int64), h - 1)
    return img[yi[:, None], xi[None, :]]


# ---------------------------------------------------------------- polygons

# edge x in fixed point with 32 fraction bits: an edge spans at most
# the image's rows once clipped, so its truncated slope drifts by less
# than 2**-32 a row, below the 1 / (2 rows) spacing of exact ties
_XY_SHIFT = 32
_XY_ONE = 1 << _XY_SHIFT


def _trunc_div(a: int, b: int) -> int:
    """C's integer division (towards zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def _clip_line(W: int, H: int, p1, p2):
    """cv2.clipLine on integer points: (inside, p1, p2)."""
    right, bottom = W - 1, H - 1
    x1, y1 = p1
    x2, y2 = p2

    def code(x, y):
        return (x < 0) + (x > right) * 2 + (y < 0) * 4 + (y > bottom) * 8

    c1, c2 = code(x1, y1), code(x2, y2)
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    return (c1 | c2) == 0, (x1, y1), (x2, y2)


def _draw_line(mask: np.ndarray, p1, p2, value) -> None:
    """cv2's 8-connected line (LineIterator, left to right) from p1 to
    p2, clipped to the image, in closed form: after k steps along the
    major axis the minor axis has moved ceil((2 dy k - dx) / (2 dx))."""
    H, W = mask.shape[:2]
    inside, p1, p2 = _clip_line(W, H, p1, p2)
    if not inside:
        return
    (x1, y1), (x2, y2) = p1, p2
    dx, dy = x2 - x1, y2 - y1
    if dx < 0:
        dx, dy = -dx, -dy
        x1, y1 = x2, y2
    sy = 1
    if dy < 0:
        dy, sy = -dy, -1
    vert = dy > dx
    if vert:
        dx, dy = dy, dx
    k = np.arange(dx + 1, dtype=np.int64)
    minor = -np.floor_divide(dx - 2 * dy * k, 2 * dx) if dx > 0 else np.zeros(1, np.int64)
    if vert:
        xs, ys = x1 + minor, y1 + sy * k
    else:
        xs, ys = x1 + k, y1 + sy * minor
    mask[ys, xs] = value


def fill_poly(mask: np.ndarray, pts, value) -> np.ndarray:
    """cv2.fillPoly(mask, [pts], value) for one polygon of integer
    vertices [n, 2] (x, y) on a 2D mask, in place; returns mask. The
    outline is drawn with cv2's 8-connected lines (clipped), then the
    even-odd scanline fill: each edge's x in fixed point, advanced by the
    truncated slope each row, each span [round(x_left),
    floor(x_right)] of the sorted crossings filled. An edge that leaves
    the image is replaced by its clipped part (a vertical edge at the
    clipped point when that part is one pixel), and on the rows beyond an
    end clipped at the left or right border it runs down x = -1 or x = W."""
    H, W = mask.shape[:2]
    v = [(int(x), int(y)) for x, y in np.asarray(pts).reshape(-1, 2)]
    edges = []  # (top y, bottom y, x at top y, dx, clipped top x, y, bottom y, x above, x below)
    p0 = v[-1]
    for p1 in v:
        _draw_line(mask, p0, p1, value)
        c0, c1 = (p0[0] << _XY_SHIFT, p0[1]), (p1[0] << _XY_SHIFT, p1[1])
        if not (0 <= p0[0] < W and 0 <= p1[0] < W and 0 <= p0[1] < H and 0 <= p1[1] < H):
            _, t0, t1 = _clip_line(W, H, p0, p1)
            if t0[1] == t1[1]:
                c0, c1 = (t0[0] << _XY_SHIFT, p0[1]), (t1[0] << _XY_SHIFT, p1[1])
            else:
                c0, c1 = (t0[0] << _XY_SHIFT, t0[1]), (t1[0] << _XY_SHIFT, t1[1])
        if p0[1] != p1[1]:
            dx = _trunc_div(c1[0] - c0[0], c1[1] - c0[1])
            (top, ty), (bot, by) = sorted([(c0, p0[1]), (c1, p1[1])], key=lambda a: a[1])

            def beyond(c, y):
                # x on the rows past an end moved by the clip to a side border
                if c[1] == y:
                    return None
                return -_XY_ONE if c[0] == 0 else (W << _XY_SHIFT) if c[0] == (W - 1) << _XY_SHIFT else None

            edges.append((ty, by, top[0] + (ty - top[1]) * dx, dx, top[0], top[1], bot[1],
                          beyond(top, ty), beyond(bot, by)))
        p0 = p1
    if len(edges) < 2:
        return mask
    # the whole polygon above, below, left or right of the image (exact ints)
    x_ends = [x for ed in edges for x in (ed[2], ed[2] + (ed[1] - ed[0]) * ed[3])]
    if (max(ed[1] for ed in edges) < 0 or min(ed[0] for ed in edges) >= H or max(x_ends) < 0
            or min(x_ends) >= (W << _XY_SHIFT)):
        return mask
    e = np.array([(ed[0], ed[1], ed[4], ed[5], ed[3]) for ed in edges], np.int64)
    y0, y1, cx, cy, dxs = e.T
    ys = np.arange(max(int(y0.min()), 0), min(int(y1.max()), H), dtype=np.int64)
    if ys.size == 0:
        return mask
    active = (ys[None, :] >= y0[:, None]) & (ys[None, :] < y1[:, None])  # [E, rows]
    # from the clipped top end (inside the image), so that no product overflows
    x = cx[:, None] + (ys[None, :] - cy[:, None]) * dxs[:, None]
    for k, ed in enumerate(edges):
        if ed[7] is not None:
            x[k] = np.where(ys < ed[5], ed[7], x[k])
        if ed[8] is not None:
            x[k] = np.where(ys > ed[6], ed[8], x[k])
    x = np.sort(np.where(active, x, np.iinfo(np.int64).max), axis=0)
    n = active.sum(axis=0)
    for j in range(0, x.shape[0] - 1, 2):
        ok = n >= j + 2
        xl = (x[j][ok] + (_XY_ONE >> 1)) >> _XY_SHIFT
        xr = x[j + 1][ok] >> _XY_SHIFT
        keep = (xl < W) & (xr >= 0)
        for r, a, b in zip(ys[ok][keep], np.maximum(xl[keep], 0), np.minimum(xr[keep], W - 1)):
            mask[r, a : b + 1] = value
    return mask
