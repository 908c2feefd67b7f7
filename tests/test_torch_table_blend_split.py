"""The segment algebra of the port's dense-table blend kernels.

On the card `tile_raster.tile_blend` and `tile_blend_bwd` cut a tile of
more than `SEG_CHUNKS` 128-lane chunks into segments and give every
segment its own thread block (`csrc/tile_blend_table.cu`,
`csrc/tile_blend_table_bwd.cu`). The CUDA kernels cannot run here, so
the algebra that makes the segments independent is written once more
below in plain PyTorch (`blend_table_segmented`,
`blend_table_segmented_bwd`): a first pass multiplies each chunk's
(1 - alpha) per pixel over its passing lanes, in lane order from 1, with
no stop; a pixel enters segment k with T = those products of the
earlier chunks folded in chunk order and had stopped before it exactly
when T < 1e-4; each segment walks its chunks from that state alone into
a partial accumulator; the partials are added in segment order; the
backward's prefix of u entering a segment is g . (the partials before
it). The walk is the kernels' own, lane after lane in f32 (`walk_chunk`),
so its pass and stop decisions are the kernels'.

Exact checks: the work list (`table_plan_plain`, which the card tests
hold the kernels' list against); for every segment length the lane at
which each pixel stops, the set of blended (pixel, slot) pairs and the
final T equal those of the unsplit walk (`walk_unsplit`, a transcription
of the one-block walk); with one segment a tile the output is the
unsplit walk's bit for bit.

Tolerances, as tests/test_torch_table_blend.py: the forward by
chip_smoke.compare_blend's rule (1e-5 * max(1, |ref|), a stop that lands
within rounding of 1e-4 may move by one Gaussian in at most one pixel),
the backward each gradient row scaled by its largest |reference value|
to atol 1e-5. Against the JAX kernel (Pallas in interpret mode, whose
lane products are a tree) and the port's plain versions (cumprod and
cumsum, whose CPU sums run in double), the versions differ only in the
order and precision of their sums.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import compare_blend, random_table_case
from street_gaussians_torch.ops import tile_raster as ttab
from street_gaussians_torch.ops.tile_raster import ALPHA_MAX, ALPHA_MIN, CHUNK, PAYLOAD_HEADER, PIX, T_EPS
from street_gaussians_tpu.ops.tile_raster import tile_blend as jax_blend

ATOL_SCALED = 1e-5
SEG_CHUNKS = 2  # a short segment: the 8-chunk tiles below are cut in four
K = 1024
# a 3x2 grid: two tiles at full count, a long one that ends mid-chunk, one
# of exactly two chunks (one segment), an empty one and a short one
COUNTS = (1024, 700, 256, 0, 1024, 130)
# opacities up to: pixels that survive every segment boundary (none
# stops), and a dense table whose pixels stop in chunks 0 to 3
OPACITY = {"survives": 0.05, "dense": 0.99}
F = 4
GRID_X = 3


@functools.lru_cache(maxsize=None)
def make_case(name):
    return random_table_case(3, "cpu", grid_x=GRID_X, grid_y=2, F=F, K=K, counts=COUNTS,
                             opacity_hi=OPACITY[name])


def _chunk(payload, tiles, c, px, py):
    """Chunk c of the tables of `tiles`, per (tile, pixel, lane), in the
    kernels' arithmetic (blend_common.cuh's eval_alpha)."""
    blk = payload[tiles, :, c * CHUNK:(c + 1) * CHUNK]  # [m, c_pad, 128]
    mx, my, ca, cb, cc, op = blk[:, :PAYLOAD_HEADER, None, :].unbind(1)  # [m, 1, 128] each
    dx = mx - px[:, :, None]
    dy = my - py[:, :, None]
    power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
    apow = torch.exp(torch.clamp(power, max=0.0))
    alpha_raw = op * apow
    alpha = torch.clamp(alpha_raw, max=ALPHA_MAX)
    passes = (power <= 0.0) & (alpha >= ALPHA_MIN)
    return dict(blk=blk, dx=dx, dy=dy, conic=(ca, cb, cc), apow=apow, alpha_raw=alpha_raw, alpha=alpha,
                passes=passes)


def walk_chunk(k, T, done):
    """One chunk's walk, lane after lane in f32, as the kernels walk it:
    cp the product of (1 - alpha) over the blended lanes; a pixel stops
    at the first passing lane with T * cp * (1 - alpha) < 1e-4, which it
    does not blend; a blended lane weighs alpha * T * cp. Returns
    (weights [m, 256, 128], tprefix = T * cp before each lane, blended
    and stopping masks, the chunk's cp, the new done)."""
    alpha, passes = k["alpha"], k["passes"]
    m = T.shape[0]
    cp = torch.ones((m, PIX))
    done = done.clone()
    w = torch.zeros_like(alpha)
    tprefix = torch.zeros_like(alpha)
    blend = torch.zeros_like(passes)
    stop = torch.zeros_like(passes)
    for lane in range(CHUNK):
        a = alpha[:, :, lane]
        act = passes[:, :, lane] & ~done
        cp_incl = cp * (1.0 - a)
        st = act & (T * cp_incl < T_EPS)
        bl = act & ~st
        w[:, :, lane] = torch.where(bl, a * T * cp, 0.0)
        tprefix[:, :, lane] = T * cp
        blend[:, :, lane], stop[:, :, lane] = bl, st
        cp = torch.where(bl, cp_incl, cp)
        done |= st
    return w, tprefix, blend, stop, cp, done


def _chunk_products(k):
    """The first pass: each pixel's product of (1 - alpha) over the
    chunk's passing lanes, in lane order from 1, with no stop."""
    P = torch.ones(k["alpha"].shape[:2])
    for lane in range(CHUNK):
        P = torch.where(k["passes"][:, :, lane], P * (1.0 - k["alpha"][:, :, lane]), P)
    return P


class Walk:
    """What a walk over some chunks of one tile leaves: the features
    blended, T, the stop lane (-1: never) and the blended (pixel, slot)
    pairs, and per chunk the weights the backward needs. Every walk takes
    one tile, so that each value comes from tensors of the same shape
    (the CPU's exp rounds alike then, whatever the threads)."""

    def __init__(self, T0):
        self.T = T0.clone()
        self.done = ~(T0 >= T_EPS)
        self.accum = torch.zeros((T0.shape[0], PIX, F))
        self.stop_lane = torch.full((T0.shape[0], PIX), -1, dtype=torch.int64)
        self.blended = torch.zeros((T0.shape[0], PIX, K), dtype=torch.bool)
        self.chunks = {}  # c -> (chunk, w, tprefix, blend, active tiles)

    def run(self, payload, tiles, c_first, c_stop, grid_x):
        px, py = ttab._pixel_coords(tiles, grid_x)
        for c in range(c_first, int(c_stop.max()) if tiles.numel() else 0):
            act = ((c < c_stop) & ~self.done.all(dim=1)).nonzero().squeeze(1)  # the chunk skip
            if act.numel() == 0:
                break
            k = _chunk(payload, tiles[act], c, px[act], py[act])
            w, tprefix, blend, stop, cp, done = walk_chunk(k, self.T[act], self.done[act])
            feat = k["blk"][:, PAYLOAD_HEADER:PAYLOAD_HEADER + F, :]  # [m, F, 128]
            acc = self.accum[act]
            for lane in range(CHUNK):  # accum[f] += w * feat[f], lane after lane
                acc = acc + w[:, :, lane, None] * feat[:, None, :, lane]
            self.accum[act] = acc
            lanes = torch.arange(CHUNK)
            first = torch.where(stop, lanes, CHUNK).amin(dim=2)
            sl = self.stop_lane[act]
            self.stop_lane[act] = torch.where(first < CHUNK, c * CHUNK + first, sl)
            bl = self.blended[act]
            bl[:, :, c * CHUNK:(c + 1) * CHUNK] = blend
            self.blended[act] = bl
            self.T[act] = self.T[act] * cp
            self.done[act] = done
            self.chunks[c] = (k, w, tprefix, blend, act)
        return self


def walk_unsplit(payload, counts, grid_x):
    """The one-block walk, every tile from its first chunk with T = 1:
    (out [T, 256, F + 1], stop lanes [T, 256], blended pairs [T, 256, K])."""
    nch = ttab._num_chunks(counts, K)
    walks = [Walk(torch.ones((1, PIX))).run(payload, torch.tensor([t]), 0, nch[t:t + 1], grid_x)
             for t in range(counts.numel())]
    out = torch.cat([torch.cat([w.accum, w.T[:, :, None]], dim=2) for w in walks])
    return out, torch.cat([w.stop_lane for w in walks]), torch.cat([w.blended for w in walks])


def _items(counts, seg_chunks):
    plan = ttab.table_plan_plain(counts, K, seg_chunks)
    tile, seg = plan["item_tile"].long(), plan["item_seg"].long()
    nch = ttab._num_chunks(counts, K)[tile]
    c_first = seg * seg_chunks
    c_stop = torch.minimum(c_first + seg_chunks, nch)
    return plan, tile, seg, c_first, c_stop, c_stop == nch


def blend_table_segmented(payload, counts, grid_x, seg_chunks):
    """(out, state): every tile walked in segments, each from its entering
    T alone, the partials added in segment order."""
    plan, tile, seg, c_first, c_stop, last = _items(counts, seg_chunks)
    slot = plan["tile_slot"].long()
    n = tile.numel()
    px, py = ttab._pixel_coords(tile, grid_x)
    # the first pass: P_c of every chunk of a long tile's segments but its last
    prod = {}
    for i in range(plan["n_long"]):
        if bool(last[i]):
            continue
        for c in range(int(c_first[i]), int(c_stop[i])):
            prod[(int(tile[i]), c)] = _chunk_products(_chunk(payload, tile[i:i + 1], c, px[i:i + 1], py[i:i + 1]))[0]
    T0 = torch.ones((n, PIX))
    for i in range(n):
        for c in range(int(c_first[i])):  # T = T * P_c in chunk order
            T0[i] = T0[i] * prod[(int(tile[i]), c)]
    entered = T0 >= T_EPS
    walks = []
    for i in range(n):  # each item alone, from its own state
        walks.append(Walk(T0[i:i + 1]).run(payload, tile[i:i + 1], int(c_first[i]), c_stop[i:i + 1], grid_x))
    part = torch.zeros((n, PIX, F + 1))
    for i, wk in enumerate(walks):
        holds_t = entered[i] & (wk.done[0] | bool(last[i]))
        part[i, :, :F] = wk.accum[0]
        part[i, :, F] = torch.where(holds_t, wk.T[0], 0.0)
    out = torch.zeros((counts.numel(), PIX, F + 1))
    for i in range(n):  # a tile's items in segment order
        out[tile[i]] += part[i]
    assert all(int(slot[tile[i]]) == (i - int(seg[i]) if int(slot[tile[i]]) >= 0 else -1) for i in range(n))
    stop_lane = torch.full((counts.numel(), PIX), -1, dtype=torch.int64)
    blended = torch.zeros((counts.numel(), PIX, K), dtype=torch.bool)
    for i, wk in enumerate(walks):
        stop_lane[tile[i]] = torch.where(wk.stop_lane[0] >= 0, wk.stop_lane[0], stop_lane[tile[i]])
        blended[tile[i]] |= wk.blended[0]
    state = dict(plan=plan, tile=tile, seg=seg, T0=T0, entered=entered, part=part, walks=walks,
                 stop_lane=stop_lane, blended=blended)
    return out, state


def blend_table_segmented_bwd(payload, counts, out, gout, state):
    """d_payload from independent segments: each re-walks its chunks from
    its entering T with the prefix of u = g . (the partials before the
    segment), and writes only its own slots; zeros elsewhere."""
    tile, seg = state["tile"], state["seg"]
    d_payload = torch.zeros_like(payload)
    for i, wk in enumerate(state["walks"]):
        t = int(tile[i])
        g = gout[t, :, :F]
        s_total = (g * out[t, :, :F]).sum(dim=1)
        gt_tfin = gout[t, :, F] * out[t, :, F]
        before = torch.zeros((PIX, F))
        for j in range(i - int(seg[i]), i):  # the tile's earlier segments, in order
            before = before + state["part"][j, :, :F]
        u_prev = (g * before).sum(dim=1)
        for c in sorted(wk.chunks):
            k, w, tprefix, blend, _ = wk.chunks[c]
            dx, dy, (ca, cb, cc) = k["dx"][0], k["dy"][0], [x[0] for x in k["conic"]]
            a = torch.where(blend[0], k["alpha"][0], 0.0)
            phi = g @ k["blk"][0, PAYLOAD_HEADER:PAYLOAD_HEADER + F, :]  # [256, 128]
            u = w[0] * phi
            suffix = s_total[:, None] - (torch.cumsum(u, dim=1) + u_prev[:, None])
            da = torch.where(blend[0], tprefix[0] * phi - (suffix + gt_tfin[:, None]) / (1.0 - a), 0.0)
            da_eff = torch.where(k["alpha_raw"][0] <= ALPHA_MAX, da, 0.0)
            dpow = k["alpha_raw"][0] * da_eff
            gmx, gmy = ca * dx + cb * dy, cc * dy + cb * dx
            rows = [-gmx * dpow, -gmy * dpow, -0.5 * dx * dx * dpow, -dx * dy * dpow, -0.5 * dy * dy * dpow,
                    k["apow"][0] * da_eff, *(g[:, f, None] * w[0] for f in range(F)),
                    (gmx * dpow).abs(), (gmy * dpow).abs()]
            d_payload[t, :len(rows), c * CHUNK:(c + 1) * CHUNK] = torch.stack([r.sum(dim=0) for r in rows])
            u_prev = u_prev + u.sum(dim=1)
    return d_payload


@functools.lru_cache(maxsize=None)
def jax_reference(name):
    """(out, d_payload, gout) of the JAX kernel and its VJP on the case."""
    payload, counts, _, gx = make_case(name)
    gout = np.random.default_rng(11).normal(size=(counts.numel(), PIX, F + 1)).astype(np.float32)
    fn = lambda p: jax_blend(p, jnp.asarray(counts.numpy()), F, gx, True)  # noqa: E731
    out, vjp = jax.vjp(fn, jnp.asarray(payload.numpy()))
    (d_payload,) = vjp(jnp.asarray(gout))
    return np.asarray(out), np.asarray(d_payload), gout


@functools.lru_cache(maxsize=None)
def unsplit(name):
    payload, counts, _, gx = make_case(name)
    return walk_unsplit(payload, counts, gx)


@functools.lru_cache(maxsize=None)
def segmented(name, seg_chunks):
    payload, counts, _, gx = make_case(name)
    return blend_table_segmented(payload, counts, gx, seg_chunks)


def assert_rows_close(got, want):
    rows = lambda a: np.asarray(a).transpose(1, 0, 2).reshape(np.asarray(a).shape[1], -1)  # noqa: E731
    g, w = rows(got), rows(want)
    for r in range(PAYLOAD_HEADER + F + 2):
        scale = max(np.abs(w[r]).max(), 1e-30)
        np.testing.assert_allclose(g[r] / scale, w[r] / scale, atol=ATOL_SCALED, rtol=0, err_msg=f"row {r}")
    assert (g[PAYLOAD_HEADER + F + 2:] == 0).all()


@pytest.mark.parametrize("seg_chunks", [1, 2, 3, 8, 1 << 20])
def test_work_list_cuts_every_tile(seg_chunks):
    """Integers, exact: the items' chunk ranges partition each tile's
    chunks in order, none holds more than seg_chunks, long tiles' items
    come first with their slots in a row, and the list fits the bound
    the kernels' plan buffer is sized by."""
    counts = torch.tensor(COUNTS, dtype=torch.int32)
    plan, tile, seg, c_first, c_stop, last = _items(counts, seg_chunks)
    nch = ttab._num_chunks(counts, K)
    cpu = ttab.table_plan(counts, K, seg_chunks)  # the CPU path is the plain version
    assert all(torch.equal(cpu[k], plan[k]) if torch.is_tensor(plan[k]) else cpu[k] == plan[k] for k in plan)
    assert plan["n_items"] == tile.numel() == seg.numel()
    for t in range(counts.numel()):
        mine = (tile == t).nonzero().squeeze(1)
        assert mine.numel() == max(1, -(-int(nch[t]) // seg_chunks))
        assert seg[mine].tolist() == list(range(mine.numel())) and (mine[1:] - mine[:-1] == 1).all()
        assert int(c_first[mine[0]]) == 0 and (c_first[mine[1:]] == c_stop[mine[:-1]]).all()
        assert int(c_stop[mine[-1]]) == int(nch[t]) and last[mine].tolist() == [False] * (mine.numel() - 1) + [True]
        assert ((c_stop - c_first)[mine] <= seg_chunks).all()
        slot = int(plan["tile_slot"][t])
        assert (slot == int(mine[0])) if mine.numel() > 1 else (slot == -1)
    n_long = plan["n_long"]
    assert (plan["tile_slot"].long()[tile[:n_long]] >= 0).all() and (plan["tile_slot"].long()[tile[n_long:]] < 0).all()
    assert plan["n_items"] <= ttab.max_items_bound(counts.numel(), K, seg_chunks)
    if seg_chunks < K // CHUNK:
        assert n_long > 0


@pytest.mark.parametrize("seg_chunks", [1, SEG_CHUNKS, 3])
@pytest.mark.parametrize("name", list(OPACITY))
def test_stop_decisions_do_not_depend_on_the_segments(name, seg_chunks):
    """Exact: the lane at which every pixel stops, the blended (pixel,
    slot) pairs and the final T are the unsplit walk's for any cut."""
    want, stop_lane, blended = unsplit(name)
    got, st = segmented(name, seg_chunks)
    assert st["plan"]["n_long"] > 0
    assert torch.equal(st["stop_lane"], stop_lane)
    assert torch.equal(st["blended"], blended)
    assert torch.equal(got[..., F], want[..., F])


@pytest.mark.parametrize("name", list(OPACITY))
def test_one_segment_a_tile_is_the_unsplit_walk(name):
    got, st = segmented(name, 1 << 20)
    assert st["plan"]["n_long"] == 0
    assert torch.equal(got, unsplit(name)[0])


def test_cases_cross_and_stop_inside_segments():
    """The low-opacity case carries every pixel across the segment
    boundaries to the tile's end; the dense one stops pixels in the first
    segment and in later ones, and the later segments of a pixel that
    stopped add nothing and hold no T."""
    _, st = segmented("survives", SEG_CHUNKS)
    later = st["seg"] > 0
    assert st["entered"][later].all() and (st["stop_lane"] < 0).all()
    _, st = segmented("dense", SEG_CHUNKS)
    later = st["seg"] > 0
    assert ((st["stop_lane"] >= 0) & (st["stop_lane"] < SEG_CHUNKS * CHUNK)).any()
    assert (st["stop_lane"] >= SEG_CHUNKS * CHUNK).any()
    first = (st["seg"] == 0) & (st["plan"]["tile_slot"].long()[st["tile"]] >= 0)
    assert first.any()
    for i in first.nonzero().squeeze(1).tolist():
        stopped = st["walks"][i].done[0]
        assert stopped.any()
        rest = (st["tile"] == st["tile"][i]) & later
        assert not st["entered"][rest][:, stopped].any()
        assert (st["part"][rest][:, stopped] == 0).all()


@pytest.mark.parametrize("seg_chunks", [1, SEG_CHUNKS])
@pytest.mark.parametrize("name", list(OPACITY))
def test_segmented_forward_matches_plain(name, seg_chunks):
    payload, counts, _, gx = make_case(name)
    got, _ = segmented(name, seg_chunks)
    compare_blend(got, ttab.tile_blend_plain(payload, counts, F, gx), F, f"segmented table {name}")


@pytest.mark.parametrize("name", list(OPACITY))
def test_segmented_forward_matches_jax(name):
    got, _ = segmented(name, SEG_CHUNKS)
    want = jax_reference(name)[0]
    compare_blend(got, torch.tensor(want), F, f"segmented table {name} against JAX")
    assert (want[..., -1] < 1e-3).any() == (name == "dense")


@pytest.mark.parametrize("seg_chunks", [1, SEG_CHUNKS])
@pytest.mark.parametrize("name", list(OPACITY))
def test_segmented_backward_matches_plain(name, seg_chunks):
    payload, counts, _, gx = make_case(name)
    gout = torch.as_tensor(jax_reference(name)[2])
    out, st = segmented(name, seg_chunks)
    got = blend_table_segmented_bwd(payload, counts, out, gout, st)
    plain_out = ttab.tile_blend_plain(payload, counts, F, gx)
    assert_rows_close(got, ttab.tile_blend_bwd_plain(payload, counts, plain_out, gout, F, gx))


@pytest.mark.parametrize("name", list(OPACITY))
def test_segmented_backward_matches_jax_vjp(name):
    payload, counts, _, gx = make_case(name)
    _, want, gout = jax_reference(name)
    out, st = segmented(name, SEG_CHUNKS)
    got = blend_table_segmented_bwd(payload, counts, out, torch.as_tensor(gout), st)
    assert_rows_close(got, want)
    # the slots no segment walks hold 0, as in the JAX kernel
    walked = torch.zeros((counts.numel(), K), dtype=torch.bool)
    for i, wk in enumerate(st["walks"]):
        for c in wk.chunks:
            walked[st["tile"][i], c * CHUNK:(c + 1) * CHUNK] = True
    assert (got.transpose(1, 2)[~walked] == 0).all() and (want.transpose(0, 2, 1)[~walked.numpy()] == 0).all()


def test_cpu_path_keeps_no_state():
    """On the CPU the wrappers run the plain versions: no boundary state,
    and tile_blend_bwd takes none."""
    payload, counts, _, gx = make_case("dense")
    out, state = ttab._forward(payload, counts, F, gx)
    assert state is None and torch.equal(out, ttab.tile_blend_plain(payload, counts, F, gx))
    gout = torch.as_tensor(jax_reference("dense")[2])
    p = payload.clone().requires_grad_(True)
    ttab.TileBlend.apply(p, counts, F, gx).backward(gout)
    assert torch.equal(p.grad, ttab.tile_blend_bwd_plain(payload, counts, out, gout, F, gx))
