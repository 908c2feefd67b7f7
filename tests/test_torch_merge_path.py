"""The merge-path partition of the segmented row-sum (csrc/segsum.cu)
and of the run expansion (csrc/fill.cu), in plain PyTorch on the CPU:

- the partition (`merge_path_plain`, `merge_path_runs_plain`): tiles of
  equal length that together cover every segment, row, run and slot
  once, each boundary a valid point of the merge;
- the kernel's order of sums (`segment_rowsum_emulated`): equal bit for
  bit to a loop-by-loop transcription of the CUDA kernel below, exact on
  integer-valued rows (so each row with a key < N is added once, to its
  segment), and within 1e-5 of the JAX package's segment_rowsum (Pallas
  in interpret mode; both sum f32 rows, in other orders);
- the expansion walked through the partition (`expand_runs_partitioned`):
  equal to the JAX package's expand_runs bit for bit (a copy, no sums).

Tiles are cut small (32 or 64 threads, 3 or 4 items) so that a few
hundred rows span several tiles; the kernels' own sizes are a case too.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from street_gaussians_torch.ops import fill as tfill
from street_gaussians_torch.ops import segsum as tseg
from street_gaussians_tpu.ops import segsum as jseg
from street_gaussians_tpu.ops.fill import expand_runs as jax_expand_runs

# (threads, items per thread); the last are the kernels' own
TILINGS = [(32, 4), (64, 3), (tseg.SEG_THREADS, tseg.SEG_ITEMS)]
CAP, GROUP = 128, 16  # the JAX op's padding multiples of L and N


def _keys_case(name, rng):
    """(N, sorted int32 keys, L a multiple of CAP, N of GROUP)."""
    if name == "identity":
        N, keys = 304, rng.integers(0, 304, 1024)
    elif name == "empty_and_padding":
        # keys in the low half only, some repeated many times; a fifth of
        # the rows padding
        N, keys = 400, rng.integers(0, 200, 1024) // 3 * 3
        keys[:200] = tseg.BIG
    elif name == "long_segment":
        # one segment of 900 rows: several tiles at the small tilings
        N, keys = 64, np.concatenate([np.full(900, 17), rng.integers(0, 64, 252)])
    elif name == "all_empty":
        N, keys = 208, np.full(384, tseg.BIG)
    else:
        raise ValueError(name)
    return N, np.sort(keys).astype(np.int32)


CASES = ["identity", "empty_and_padding", "long_segment", "all_empty"]


def _search(diag, a_len, b_len, a_before_b):
    lo, hi = max(0, diag - b_len), min(diag, a_len)
    while lo < hi:
        mid = (lo + hi) // 2
        if a_before_b(mid, diag - mid - 1):
            lo = mid + 1
        else:
            hi = mid
    return lo


def _search_warp(diag, a_len, b_len, a_before_b):
    """merge_path.cuh's merge_path_search_warp: 32 probes a round."""
    lo, hi = max(0, diag - b_len), min(diag, a_len)
    while lo < hi:
        step = (hi - lo + 31) >> 5
        k = sum(m < hi and a_before_b(m, diag - m - 1) for m in (lo + lane * step for lane in range(32)))
        if k == 0:
            hi = lo
        else:
            last = lo + (k - 1) * step
            lo, hi = last + 1, min(hi, last + step)
    return lo


def _kernel_transcript(d, keys, N, threads, items):
    """csrc/segsum.cu's identity path, loop by loop in numpy float32:
    per tile its two searches, per thread its search and walk, the
    warps' Kogge-Stone scans and the warps' carries, per tile its last
    carry, then the fix-up across tiles."""
    f32 = np.float32
    C, L = d.shape
    total, tile, W = N + L, threads * items, threads // 32
    tiles = -(-total // tile)
    out = np.zeros((C, N), f32)
    carry = np.zeros((tiles, C), f32)
    tile_seg = np.full(tiles + 1, N)

    def point(diag):
        i = _search(diag, N, L, lambda s, r: keys[r] > s)
        return i, diag - i

    for b in range(tiles):
        (i0, j0), (i1, j1) = point(min(b * tile, total)), point(min((b + 1) * tile, total))
        tile_seg[b] = i0
        if i0 >= N:
            continue
        nsegs, nrows = i1 - i0, j1 - j0
        key_s = keys[j0:j1]
        walks = []
        for t in range(threads):
            ld = min(t * items, nsegs + nrows)
            it0 = _search(ld, nsegs, nrows, lambda s, r: key_s[r] > i0 + s)
            it, jt, ends = it0, ld - it0, []
            for _ in range(min(items, nsegs + nrows - ld)):
                e = it < nsegs and (jt >= nrows or key_s[jt] > i0 + it)
                ends.append(e)
                it, jt = it + e, jt + (not e)
            walks.append((it0, ld - it0, ends))
        for c in range(C):
            row_s = d[c, j0:j1]
            out_s = np.zeros(nsegs, f32)
            acc_l, seg_l, head_l = [], [], []
            for it0, jt0, ends in walks:
                acc, head, it, jt = f32(0), None, it0, jt0
                for e in ends:
                    if e:
                        if it == it0:
                            head = acc
                        else:
                            out_s[it] = acc
                        acc, it = f32(0), it + 1
                    else:
                        acc, jt = f32(acc + row_s[jt]), jt + 1
                acc_l.append(acc)
                seg_l.append(it)
                head_l.append(head)
            v = list(acc_l)
            for w in range(W):
                for off in (1, 2, 4, 8, 16):
                    old = v[w * 32:(w + 1) * 32]
                    for lane in range(off, 32):
                        t = w * 32 + lane
                        if seg_l[t - off] == seg_l[t]:
                            v[t] = f32(old[lane - off] + old[lane])
            warp_v = [v[w * 32 + 31] for w in range(W)]
            warp_s = [seg_l[w * 32 + 31] for w in range(W)]
            fs = []
            for t in range(threads):
                w, f = t // 32, f32(0)
                if w > 0:
                    f = warp_v[0]
                    for ww in range(1, w):
                        f = f32(f + warp_v[ww]) if warp_s[ww] == warp_s[ww - 1] else warp_v[ww]
                    if seg_l[t] == warp_s[w - 1]:
                        v[t] = f32(f + v[t])
                fs.append(f)
            for t in range(threads):
                if head_l[t] is not None:
                    before = v[t - 1] if t % 32 else fs[t]
                    out_s[walks[t][0]] = f32(before + head_l[t]) if t > 0 else head_l[t]
            carry[b, c] = v[threads - 1]
            out[c, i0:i1] = out_s
    for b in range(1, tiles):
        s = tile_seg[b]
        if s >= N or tile_seg[b + 1] == s:
            continue
        a = b - 1
        while a > 0 and tile_seg[a] == s:
            a -= 1
        for c in range(C):
            x = carry[a, c]
            for k in range(a + 1, b):
                x = f32(x + carry[k, c])
            out[c, s] = f32(x + out[c, s])
    return out


@pytest.mark.parametrize("tiling", TILINGS)
@pytest.mark.parametrize("case", CASES)
def test_segment_partition_covers_everything_once(case, tiling):
    """Tile boundaries are points of the merge (at a point (i, j) the
    rows placed belong to segments <= i, and the segments < i have all
    their rows placed), every tile but the last holds
    exactly threads * items items, and the tiles run from (0, 0) to
    (N, L): each segment end and each row in exactly one tile."""
    N, keys = _keys_case(case, np.random.default_rng(0))
    L, tile = keys.size, tiling[0] * tiling[1]
    total = N + L
    diags = torch.as_tensor(np.minimum(np.arange(0, total + tile, tile), total))
    i, j = (x.numpy() for x in tseg.merge_path_plain(torch.as_tensor(keys), N, diags))
    assert (i[0], j[0], i[-1], j[-1]) == (0, 0, N, L)
    assert (np.diff(i) >= 0).all() and (np.diff(j) >= 0).all()
    assert (np.diff(i + j)[:-1] == tile).all() and 0 < np.diff(i + j)[-1] <= tile
    for dg, ib, jb in zip(diags.tolist(), i, j):
        assert (np.minimum(keys[:jb], N) <= ib).all()  # rows placed: segments <= ib (padding: N)
        assert (keys < ib).sum() <= jb  # segments < ib have all their rows placed
        # the kernels' two searches find the same point
        before = lambda s, r: keys[r] > s  # noqa: E731
        assert _search(dg, N, L, before) == _search_warp(dg, N, L, before) == ib


@pytest.mark.parametrize("tiling", TILINGS)
@pytest.mark.parametrize("case", CASES)
def test_emulated_order_sums_each_row_once(case, tiling):
    """Integer-valued rows sum exactly in any order: equal to the plain
    version bit for bit, so each row with a key < N was added once, to
    its own segment, and no padding row was."""
    rng = np.random.default_rng(1)
    N, keys = _keys_case(case, rng)
    d = torch.as_tensor(rng.integers(-50, 50, (3, keys.size)).astype(np.float32))
    k = torch.as_tensor(keys)
    got = tseg.segment_rowsum_emulated(d, k, num_segments=N, threads=tiling[0], items=tiling[1])
    assert torch.equal(got, tseg.segment_rowsum_plain(d, k, num_segments=N))


@pytest.mark.parametrize("tiling", TILINGS[:2])
@pytest.mark.parametrize("case", ["identity", "long_segment"])
def test_emulated_order_is_the_kernels(case, tiling):
    """The vectorised emulation adds in the CUDA kernel's order: equal
    bit for bit to a transcription of the kernel's loops."""
    rng = np.random.default_rng(2)
    N, keys = _keys_case(case, rng)
    keys = keys[: 5 * tiling[0] * tiling[1]]  # a few tiles: the transcript is slow
    d = (rng.standard_normal((2, keys.size)) * 10.0 ** rng.integers(-3, 4, (2, keys.size))).astype(np.float32)
    got = tseg.segment_rowsum_emulated(torch.as_tensor(d), torch.as_tensor(keys), num_segments=N,
                                       threads=tiling[0], items=tiling[1]).numpy()
    np.testing.assert_array_equal(got, _kernel_transcript(d, keys, N, *tiling))


@functools.lru_cache(maxsize=None)
def _jax_segsum(case):
    """(N, keys, d, the JAX op's sums): once per case for all tilings."""
    rng = np.random.default_rng(3)
    N, keys = _keys_case(case, rng)
    d = rng.standard_normal((5, keys.size)).astype(np.float32)
    want = np.asarray(jseg.segment_rowsum(jnp.asarray(d), jnp.asarray(keys), num_segments=N,
                                          cap=CAP, group=GROUP, interpret=True))
    return N, keys, d, want


@pytest.mark.parametrize("tiling", TILINGS)
@pytest.mark.parametrize("case", CASES)
def test_emulated_order_matches_jax(case, tiling):
    """Within the JAX op's tolerance (1e-5, as tests/test_torch_segsum.py):
    both sum f32 rows, the JAX kernel by 128-row chunks, the emulation
    by the partition's parts; empty segments are 0."""
    N, keys, d, want = _jax_segsum(case)
    got = tseg.segment_rowsum_emulated(torch.as_tensor(d), torch.as_tensor(keys), num_segments=N,
                                       threads=tiling[0], items=tiling[1]).numpy()
    # the 900-row segment: atol 1e-4, as tests/test_torch_segsum.py's
    # segment spanning chunks
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4 if case == "long_segment" else 1e-5)
    empty = ~np.isin(np.arange(N), keys)
    assert (got[:, empty] == 0).all()


def _runs_case(name, rng):
    """(vals [4, N], offs, total, S) with S a multiple of 512 (JAX)."""
    if name == "ragged":
        cnt = rng.integers(0, 9, 700)
        cnt[rng.uniform(size=700) < 0.3] = 0
        S = 2048
    elif name == "long_runs":
        cnt = np.array([0, 1500, 3, 0, 0, 700, 1, 0, 200] * 2)
        S = 4096
    elif name == "clamped":
        cnt = rng.integers(0, 40, 100)  # total beyond S
        S = 1024
    elif name == "all_empty":
        cnt = np.zeros(64, np.int64)
        S = 512
    else:
        raise ValueError(name)
    cnt = cnt.astype(np.int32)
    offs = (np.cumsum(cnt) - cnt).astype(np.int32)
    vals = np.stack([rng.integers(0, 1 << 22, cnt.size).astype(np.float32),
                     rng.normal(size=cnt.size).astype(np.float32) * 1e3,
                     rng.normal(size=cnt.size).astype(np.float32) * 1e-4,
                     -np.arange(cnt.size, dtype=np.float32)])
    return vals, offs, int(offs[-1] + cnt[-1]), S


RUN_CASES = ["ragged", "long_runs", "clamped", "all_empty"]


@pytest.mark.parametrize("tiling", TILINGS)
@pytest.mark.parametrize("case", RUN_CASES)
def test_run_partition_covers_everything_once(case, tiling):
    """As the segment partition: tiles of equal length from (0, 0) to
    (N, S), each boundary a point of the merge of the run ends with
    the slots."""
    vals, offs, total, S = _runs_case(case, np.random.default_rng(4))
    N, tile = offs.size, tiling[0] * tiling[1]
    diags = torch.as_tensor(np.minimum(np.arange(0, N + S + tile, tile), N + S))
    i, j = (x.numpy() for x in tfill.merge_path_runs_plain(
        torch.as_tensor(offs), torch.tensor(total, dtype=torch.int32), S, diags))
    assert (i[0], j[0], i[-1], j[-1]) == (0, 0, N, S)
    assert (np.diff(i) >= 0).all() and (np.diff(j) >= 0).all()
    assert (np.diff(i + j)[:-1] == tile).all()
    ends = np.minimum(np.append(offs[1:], total), S)
    for dg, ib, jb in zip(diags.tolist(), i, j):
        assert ib == 0 or ends[ib - 1] <= jb  # runs ended before the point end at or before it
        assert ib == N or ends[ib] >= jb  # slots placed before it lie before the open run's end
        before = lambda r, s: ends[r] <= s  # noqa: E731
        assert _search(dg, N, S, before) == _search_warp(dg, N, S, before) == ib


@functools.lru_cache(maxsize=None)
def _jax_expand(case):
    """The case and the JAX op's expansion: once per case."""
    vals, offs, total, S = _runs_case(case, np.random.default_rng(5))
    want = np.asarray(jax_expand_runs(jnp.asarray(vals), jnp.asarray(offs),
                                      jnp.asarray(total, jnp.int32), S, interpret=True))
    return vals, offs, total, S, want


@pytest.mark.parametrize("tiling", TILINGS)
@pytest.mark.parametrize("case", RUN_CASES)
def test_partitioned_expansion_matches_jax(case, tiling):
    vals, offs, total, S, want = _jax_expand(case)
    got = tfill.expand_runs_partitioned(torch.as_tensor(vals), torch.as_tensor(offs),
                                        torch.tensor(total, dtype=torch.int32), S,
                                        threads=tiling[0], items=tiling[1]).numpy()
    np.testing.assert_array_equal(got, want)


def test_partition_index_range_is_checked():
    """The kernel's merge indices are int32: N + S at or near 2^31 is
    refused before anything is allocated."""
    vals, offs = torch.zeros((1, 4)), torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="2\\*\\*31"):
        tfill.expand_runs(vals, offs, torch.tensor(0, dtype=torch.int32), 2**31 - 2**16)
