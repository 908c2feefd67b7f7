"""The segment algebra of the port's two main-path blend kernels.

On the card `tile_blend_instances` and `tile_blend_bwd` cut a long run
into segments of `SEG / 128` payload blocks and give every segment its
own thread block (`csrc/tile_blend.cu`, `csrc/tile_blend_bwd.cu`). The
CUDA kernels cannot run here, so the algebra that makes the segments
independent is written once more below in plain PyTorch
(`blend_segmented`, `blend_segmented_bwd`): a first pass sums each
segment's log1p(-alpha) per pixel with no stop; a pixel enters segment k
with the sum of the earlier segments' sums and had stopped before it
when that is below log(1e-4); each segment is blended from that state
alone into a partial accumulator; the partials are added in segment
order; the backward's prefix of u entering a segment is g . (the
accumulator before it). It is held against the port's plain versions and
against the JAX package's kernel and its VJP (Pallas in interpret mode),
and the work list (`blend_plan_plain`, which the card tests hold the
kernel's list against) is checked exactly.

Tolerances: the forward rtol = atol = 1e-5 and the backward each
gradient row scaled by its largest |reference value| to atol 1e-5, as
tests/test_torch_blend.py and tests/test_torch_blend_bwd.py: all
versions take the same log-space stop decisions and differ only in the
order of their f32 sums (here also: a long run's sums regrouped at the
segment boundaries).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import random_blend_case
from street_gaussians_torch.ops import tile_raster2 as tblend
from street_gaussians_torch.ops.tile_raster2 import CHUNK, LOG_T_EPS, PAYLOAD_HEADER, PIX
from street_gaussians_tpu.ops.tile_raster2 import tile_blend_instances as jax_blend

TOL = dict(rtol=1e-5, atol=1e-5)
ATOL_SCALED = 1e-5
SEG_BLOCKS = 2  # a small SEG of 256 lanes
# runs on a 3x2 grid: several times SEG, empty, equal to SEG, shorter,
# and one block more than a multiple; the first run starts mid-block
# (37 dead rows before it), so the others do too
RUNS = (700, 0, 256, 100, 1100, 257)
# opacity ranges: pixels that stop in the first segment, in a later one,
# never
OPACITIES = {"stops_early": (0.02, 0.99), "stops_late": (0.02, 0.4), "never_stops": (0.004, 0.008)}


def make_case(name):
    lo, hi = OPACITIES[name]
    return random_blend_case(7, "cpu", grid_x=3, grid_y=2, counts=RUNS, opacity_lo=lo, opacity_hi=hi)


def _items(starts, counts, seg_blocks):
    """The work list's items as sub-runs: (tile, seg, start, count) of
    each, and whether it holds its run's end."""
    plan = tblend.blend_plan_plain(starts, counts, seg_blocks)
    tile, seg = plan["item_tile"].long(), plan["item_seg"].long()
    s, c = starts.long()[tile], counts.long()[tile]
    lo = torch.maximum(s, (s // CHUNK + seg * seg_blocks) * CHUNK)
    hi = torch.minimum(s + c, (s // CHUNK + (seg + 1) * seg_blocks) * CHUNK)
    return plan, tile, seg, lo, (hi - lo).clamp(min=0), hi >= s + c


def _walk(payload, tile, start, cnt, grid_x, logT0, done0, per_block):
    """Walk each item's sub-run block by block from its entering state,
    as tile_blend_plain walks a run; per_block(k, act) sees every
    block."""
    n = tile.numel()
    items = torch.arange(n)
    px, py = tblend._pixel_coords(tile, grid_x)
    nb, b0 = tblend.run_blocks(start, cnt), start // CHUNK
    logT, done = logT0.clone(), done0.clone()
    for i in range(int(nb.max()) if n else 0):
        act = (i < nb).nonzero().squeeze(1)
        k = tblend._plain_block(payload, b0, start, cnt, items, act, i, px, py, done, logT)
        per_block(k, act)
        logT[act] += torch.where(k.blend, k.logs, 0.0).sum(dim=2)
        done[act] |= k.trigger.any(dim=2)
    return logT, done


def _entering(plan, tile, seg, seglog):
    """Per item: the sum, in segment order, of its tile's earlier
    segments' values."""
    enter = torch.zeros_like(seglog)
    for i in range(tile.numel()):
        for j in range(int(seg[i])):
            enter[i] += seglog[int(plan["tile_slot"][tile[i]]) + j]
    return enter


def blend_segmented(payload, starts, counts, F, grid_x, T, seg_blocks):
    """(out, state): every run blended in segments, each from its
    entering state alone, the partials combined in segment order."""
    plan, tile, seg, lo, cnt, last = _items(starts, counts, seg_blocks)
    n = tile.numel()
    # first pass: the segments' log-sums, with no stop
    base = _entering(plan, tile, seg, _logsum(payload, tile, lo, cnt, grid_x))
    entered = base >= LOG_T_EPS
    part = torch.zeros((n, PIX, F))

    def blend(k, act):
        w = torch.where(k.blend, k.a * torch.exp(k.lT + k.cums - k.logs), 0.0)
        part[act] += torch.einsum("mpl,mfl->mpf", w, k.blk[:, PAYLOAD_HEADER:PAYLOAD_HEADER + F, :])

    logT, done = _walk(payload, tile, lo, cnt, grid_x, base, ~entered, blend)
    holds_t = entered & (done | last[:, None])
    t_part = torch.where(holds_t, torch.exp(logT), 0.0)
    out = torch.zeros((T, PIX, F + 1))
    for i in range(n):  # items of a tile are in segment order
        out[tile[i], :, :F] += part[i]
        out[tile[i], :, F] += t_part[i]
    state = dict(plan=plan, tile=tile, seg=seg, lo=lo, cnt=cnt, base=base, part=part, t_part=t_part,
                 holds_t=holds_t, entered=entered)
    return out, state


def _logsum(payload, tile, start, cnt, grid_x):
    """Per item and pixel: sum of log1p(-alpha) over the lanes the pixel
    passes, block by block, with no stop."""
    n = tile.numel()
    total = torch.zeros((n, PIX))
    px, py = tblend._pixel_coords(tile, grid_x)
    nb, b0 = tblend.run_blocks(start, cnt), start // CHUNK
    never = torch.zeros((n, PIX), dtype=torch.bool)
    for i in range(int(nb.max()) if n else 0):
        act = (i < nb).nonzero().squeeze(1)
        # an entering log T of 0 and no stop: `logs` is log1p(-alpha) on
        # the passing lanes of the item's sub-run, 0 elsewhere
        k = tblend._plain_block(payload, b0, start, cnt, torch.arange(n), act, i, px, py, never,
                                torch.zeros((n, PIX)))
        total[act] += k.logs.sum(dim=2)
    return total


def blend_segmented_bwd(payload, starts, counts, out, gout, F, grid_x, T, state):
    """d_payload from independent segments: each re-walks its lanes from
    its entering log T with the prefix of u = g . (accumulator before
    the segment), and writes only its own lanes."""
    tile, seg, lo, cnt = state["tile"], state["seg"], state["lo"], state["cnt"]
    g = gout[tile, :, :F]
    s_total = (g * out[tile, :, :F]).sum(dim=2)
    gt_tfin = gout[tile, :, F] * out[tile, :, F]
    u_prev = (g * _entering(state["plan"], tile, seg, state["part"])).sum(dim=2)
    d_payload = torch.zeros_like(payload)

    def grads(k, act):
        dx, dy, (ca, cb, cc), a = k.dx, k.dy, k.conic, k.a
        tprefix = torch.exp(k.lT + k.cums - k.logs)
        w = torch.where(k.blend, a * tprefix, 0.0)
        ga = g[act]
        phi = torch.einsum("mpf,mfl->mpl", ga, k.blk[:, PAYLOAD_HEADER:PAYLOAD_HEADER + F, :])
        u = w * phi
        suffix = s_total[act][:, :, None] - (torch.cumsum(u, dim=2) + u_prev[act][:, :, None])
        da = torch.where(k.blend, tprefix * phi - (suffix + gt_tfin[act][:, :, None]) / (1.0 - a), 0.0)
        da_eff = torch.where(k.alpha_raw <= tblend.ALPHA_MAX, da, 0.0)
        dpow = k.alpha_raw * da_eff
        gmx, gmy = ca * dx + cb * dy, cc * dy + cb * dx
        rows = [-gmx * dpow, -gmy * dpow, -0.5 * dx * dx * dpow, -dx * dy * dpow, -0.5 * dy * dy * dpow,
                k.apow * da_eff, *(ga[:, :, f, None] * w for f in range(F)),
                (gmx * dpow).abs(), (gmy * dpow).abs()]
        new_rows = torch.stack([r.sum(dim=1) for r in rows], dim=1)
        new_rows = torch.where(k.slot_valid[:, None, :], new_rows, 0.0)
        d_payload[:, : new_rows.shape[1]].index_add_(0, k.bidx, new_rows)
        u_prev[act] += u.sum(dim=2)

    _walk(payload, tile, lo, cnt, grid_x, state["base"], ~state["entered"], grads)
    return d_payload


@functools.lru_cache(maxsize=None)
def jax_reference(name):
    """(out, d_payload, gout) of the JAX kernel and its VJP on the case."""
    payload, starts, counts, F, gx, T = make_case(name)
    gout = np.random.default_rng(11).normal(size=(T, PIX, F + 1)).astype(np.float32)
    fn = lambda p: jax_blend(  # noqa: E731
        p, jnp.asarray(starts.numpy()), jnp.asarray(counts.numpy()), F, gx, T, int(counts.max()) + 1, True)
    out, vjp = jax.vjp(fn, jnp.asarray(payload.numpy()))
    (d_payload,) = vjp(jnp.asarray(gout))
    return np.asarray(out), np.asarray(d_payload), gout


def live_lanes(payload, starts, counts):
    slot = np.arange(payload.shape[0] * CHUNK)
    s, c = starts.numpy()[:, None], counts.numpy()[:, None]
    return ((slot[None, :] >= s) & (slot[None, :] < s + c)).any(axis=0)


def assert_rows_close(got, want, F, live):
    lanes = lambda a: a.transpose(1, 0, 2).reshape(a.shape[1], -1)  # noqa: E731
    g, w = lanes(np.asarray(got)), lanes(np.asarray(want))
    for r in range(PAYLOAD_HEADER + F + 2):
        scale = max(np.abs(w[r, live]).max(), 1e-30)
        np.testing.assert_allclose(g[r, live] / scale, w[r, live] / scale, atol=ATOL_SCALED, rtol=0,
                                   err_msg=f"row {r}")
    assert (g[:, ~live] == 0).all() and (g[PAYLOAD_HEADER + F + 2:] == 0).all()


@pytest.mark.parametrize("seg_blocks", [1, SEG_BLOCKS, 1 << 20])
@pytest.mark.parametrize("name", list(OPACITIES))
def test_segmented_forward_matches_plain(name, seg_blocks):
    case = make_case(name)
    out, state = blend_segmented(*case, seg_blocks)
    np.testing.assert_allclose(out.numpy(), tblend.tile_blend_plain(*case).numpy(), **TOL)
    # one segment of a pixel's run holds its final T
    per_tile = torch.zeros((case[5], PIX), dtype=torch.long).index_add_(0, state["tile"], state["holds_t"].long())
    assert (per_tile == 1).all()
    if seg_blocks > 100:
        assert state["plan"]["n_long"] == 0  # nothing split: the plain blend itself


@pytest.mark.parametrize("name", list(OPACITIES))
def test_segmented_forward_matches_jax(name):
    case = make_case(name)
    out, _ = blend_segmented(*case, SEG_BLOCKS)
    want = jax_reference(name)[0]
    np.testing.assert_allclose(out.numpy(), want, **TOL)
    stopped = want[..., -1] < 2e-4
    assert stopped.any() == (name != "never_stops")


@pytest.mark.parametrize("seg_blocks", [1, SEG_BLOCKS])
@pytest.mark.parametrize("name", list(OPACITIES))
def test_segmented_backward_matches_plain(name, seg_blocks):
    case = make_case(name)
    payload, starts, counts, F, gx, T = case
    gout = torch.as_tensor(jax_reference(name)[2])
    out, state = blend_segmented(*case, seg_blocks)
    got = blend_segmented_bwd(payload, starts, counts, out, gout, F, gx, T, state)
    want = tblend.tile_blend_bwd_plain(payload, starts, counts, tblend.tile_blend_plain(*case), gout, F, gx, T)
    assert_rows_close(got, want, F, live_lanes(payload, starts, counts))


@pytest.mark.parametrize("name", list(OPACITIES))
def test_segmented_backward_matches_jax_vjp(name):
    case = make_case(name)
    payload, starts, counts, F, gx, T = case
    _, want, gout = jax_reference(name)
    out, state = blend_segmented(*case, SEG_BLOCKS)
    got = blend_segmented_bwd(payload, starts, counts, out, torch.as_tensor(gout), F, gx, T, state)
    assert_rows_close(got, want, F, live_lanes(payload, starts, counts))


def test_pixel_that_stops_in_the_first_segment():
    """Later segments add nothing to such a pixel, and its final T is
    the stopping segment's."""
    case = make_case("stops_early")
    out, st = blend_segmented(*case, SEG_BLOCKS)
    first = (st["seg"] == 0) & (st["plan"]["tile_slot"].long()[st["tile"]] >= 0)
    later = st["seg"] > 0
    assert first.any() and later.any()
    for i in first.nonzero().squeeze(1).tolist():
        stopped = st["holds_t"][i]  # first segment, not the last: holds T only where the pixel stopped
        assert stopped.any()
        rest = (st["tile"] == st["tile"][i]) & later
        assert (st["part"][rest][:, stopped] == 0).all() and (st["t_part"][rest][:, stopped] == 0).all()
        assert not st["entered"][rest][:, stopped].any()
        np.testing.assert_array_equal(out[st["tile"][i], stopped, -1].numpy(), st["t_part"][i, stopped].numpy())


@pytest.mark.parametrize("seg_blocks", [1, 2, 3, 8, 1 << 20])
def test_work_list_partitions_every_run(seg_blocks):
    """Integers, exact: the items' sub-runs partition every run in
    order, none crosses a tile or holds more than seg_blocks payload
    blocks, long tiles' items come first with their slots in a row, and
    the counts stay inside plan_bounds."""
    payload, starts, counts = make_case("stops_early")[:3]
    plan, tile, seg, lo, cnt, last = _items(starts, counts, seg_blocks)
    T = counts.numel()
    assert plan["n_items"] == tile.numel() == seg.numel()
    covered = torch.zeros(payload.shape[0] * CHUNK, dtype=torch.long)
    for t in range(T):
        mine = (tile == t).nonzero().squeeze(1)
        assert mine.numel() >= 1 and seg[mine].tolist() == list(range(mine.numel()))
        assert (mine[1:] - mine[:-1] == 1).all()  # a tile's items in a row
        # contiguous, in order, from the run's start to its end
        assert int(lo[mine[0]]) == int(starts[t]) or int(counts[t]) == 0
        assert (lo[mine[1:]] == (lo + cnt)[mine[:-1]]).all()
        assert int(cnt[mine].sum()) == int(counts[t])
        assert last[mine].tolist() == [False] * (mine.numel() - 1) + [True]
        assert (tblend.run_blocks(lo[mine], cnt[mine]) <= seg_blocks).all()
        slot = int(plan["tile_slot"][t])
        assert (slot == int(mine[0])) if mine.numel() > 1 else (slot == -1)
        for i in mine.tolist():
            covered[int(lo[i]): int(lo[i] + cnt[i])] += 1
    assert np.array_equal(covered.numpy() == 1, live_lanes(payload, starts, counts)) and int(covered.max()) <= 1
    n_long = plan["n_long"]
    assert (plan["tile_slot"].long()[tile[:n_long]] >= 0).all() and (plan["tile_slot"].long()[tile[n_long:]] < 0).all()
    max_long, max_items = tblend.plan_bounds(payload.shape[0], T, seg_blocks)
    assert n_long <= max_long and plan["n_items"] <= max_items


def test_cpu_path_keeps_no_state():
    """On the CPU the wrappers run the plain versions: no boundary state,
    and tile_blend_bwd takes none."""
    case = make_case("stops_late")
    payload, starts, counts, F, gx, T = case
    out, state = tblend._forward(*case)
    assert state is None and torch.equal(out, tblend.tile_blend_plain(*case))
    gout = torch.as_tensor(jax_reference("stops_late")[2])
    p = payload.clone().requires_grad_(True)
    tblend.TileBlendInstances.apply(p, starts, counts, F, gx, T).backward(gout)
    assert torch.equal(p.grad, tblend.tile_blend_bwd_plain(payload, starts, counts, out, gout, F, gx, T))
