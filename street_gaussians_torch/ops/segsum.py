"""Segmented row-sum: the deterministic, scatter-free gradient reduction.

Port of street_gaussians_tpu/ops/segsum.py::segment_rowsum with
`csrc/segsum.cu` in place of its TPU kernel. After the per-instance (or
per-pixel) cotangent rows are sorted by their Gaussian (or texel) id,
every segment owns one contiguous row range of the sorted array, and its
sum is a plain reduction over that range: no scatter, no atomics.

Contract (as the JAX op's): d_chan [C, L] f32 channel-major rows with
ascending int32 keys [L]; padding rows carry keys >= BIG and fall in no
segment. Segments are identity (segment g owns key g; pass
num_segments) or explicit [offs[g], ends[g]) with offs non-decreasing.
Empty segments give 0. Returns [C, N] f32. The JAX op's padding rules
(L a multiple of `cap`, N of `group`) and its bf16-addend fast path are
TPU devices and are not carried over: any L and N work, and the sums
are f32.

The kernel (identity segments) splits the merge of the segment ends
with the sorted rows into tiles of equal length (`merge_path_plain`
is that partition in plain PyTorch) and sums a segment that a thread or
tile boundary cuts in parts, combined in a fixed order: its sums repeat
bit for bit but are not the key-order sums of the plain version.
`segment_rowsum_emulated` adds in the kernel's order and equals it bit
for bit; the kernel stays within SEG_RTOL * (sum of the segment's |rows|)
of the plain version (chip_smoke.py).

`segment_rowsum` runs the plain PyTorch version for a CPU tensor and the
kernel for a CUDA tensor.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from street_gaussians_torch.kernels import _build

BIG = 1 << 30  # key of padding rows (falls in no segment)
# more nvcc flags for the library: script/search_times.py sets a probe
# build here for the length of its measurement
BUILD_FLAGS: tuple = ()
# the identity kernel's block: threads, and merged items per thread
# (csrc/segsum.cu SEG_THREADS, SEG_ITEMS)
SEG_THREADS = 256
SEG_ITEMS = 12


def _bind(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.segment_rowsum_f32.argtypes = [p, p, p, p, p, i, ctypes.c_long, i, p, p, p]
    lib.segment_rowsum_f32.restype = ctypes.c_int
    lib.segment_rowsum_tile_items.argtypes = []
    lib.segment_rowsum_tile_items.restype = ctypes.c_int


def _check_args(d_chan, keys, offs, ends, num_segments):
    if d_chan.dim() != 2 or d_chan.dtype != torch.float32:
        raise ValueError(f"segment_rowsum: d_chan must be [C, L] float32, got {tuple(d_chan.shape)}")
    L = d_chan.shape[1]
    if keys.shape != (L,) or keys.dtype != torch.int32 or keys.device != d_chan.device:
        raise ValueError(f"segment_rowsum: keys must be [{L}] int32 on d_chan's device")
    if (offs is None) != (ends is None):
        raise ValueError("segment_rowsum: pass both offs and ends, or neither")
    if offs is None:
        if num_segments is None:
            raise ValueError("segment_rowsum: identity segments need num_segments")
        return num_segments
    N = offs.shape[0]
    for name, t in (("offs", offs), ("ends", ends)):
        if t.shape != (N,) or t.dtype != torch.int32 or t.device != d_chan.device:
            raise ValueError(f"segment_rowsum: {name} must be [{N}] int32 on d_chan's device")
    if num_segments is not None and num_segments != N:
        raise ValueError(f"segment_rowsum: num_segments {num_segments} != len(offs) {N}")
    return N


def segment_rows(keys: torch.Tensor, offs, ends, num_segments: int):
    """(segment, row) of every row that falls in a segment, segment by
    segment and each segment's rows in key order: the kernel's row
    ranges, [searchsorted(keys, offs), searchsorted(keys, ends))."""
    dev = keys.device
    seg_ids = torch.arange(num_segments, dtype=torch.int32, device=dev)
    k0 = seg_ids if offs is None else offs
    k1 = seg_ids + 1 if offs is None else ends
    row0 = torch.searchsorted(keys, k0)
    count = (torch.searchsorted(keys, k1) - row0).clamp(min=0)
    seg = torch.repeat_interleave(seg_ids.long(), count)
    first = torch.repeat_interleave(row0 - (torch.cumsum(count, 0) - count), count)
    return seg, first + torch.arange(seg.numel(), device=dev)


def segment_rowsum_plain(
    d_chan: torch.Tensor,
    keys: torch.Tensor,
    offs: Optional[torch.Tensor] = None,
    ends: Optional[torch.Tensor] = None,
    *,
    num_segments: Optional[int] = None,
) -> torch.Tensor:
    """Plain PyTorch version: each segment's row range by searchsorted,
    then `index_add_` (on the CPU in key order)."""
    N = _check_args(d_chan, keys, offs, ends, num_segments)
    out = d_chan.new_zeros((d_chan.shape[0], N))
    if N == 0 or d_chan.shape[1] == 0:
        return out
    seg, row = segment_rows(keys, offs, ends, N)
    return out.index_add_(1, seg, d_chan[:, row])


def merge_path_plain(keys: torch.Tensor, num_segments: int, diags: torch.Tensor):
    """The merge-path partition of identity segments in plain PyTorch:
    for each diagonal d, the (segment, row) point (i, d - i) where the
    first d items of the merge of the segment ends 0..N-1 with the
    sorted rows are the ends of segments 0..i-1 and rows 0..d-i-1. The
    end of segment i is item i + (rows with key <= i) of the merge (a
    row with key > i comes after it), so i counts the ends placed
    before d. Rows with keys >= N come after the last end."""
    seg = torch.arange(num_segments, dtype=torch.int32, device=keys.device)
    pos = seg.long() + torch.searchsorted(keys, seg + 1)
    i = torch.searchsorted(pos, diags.long())
    return i, diags.long() - i


def segment_rowsum_emulated(
    d_chan: torch.Tensor,
    keys: torch.Tensor,
    *,
    num_segments: int,
    threads: int = SEG_THREADS,
    items: int = SEG_ITEMS,
) -> torch.Tensor:
    """Identity segments summed in the kernel's order (csrc/segsum.cu),
    in plain PyTorch on any device: tiles of threads * items merged
    items, each thread's items in order; a thread's carries combined by
    the warp's Kogge-Stone steps 1..16, then the warps' last carries
    left to right; a segment that began in an earlier tile gets those
    tiles' carries, left to right. Equal to the kernel bit for bit (f32
    sums round the same way on the card and on the CPU); the main path
    never calls it."""
    N = _check_args(d_chan, keys, None, None, num_segments)
    C, L = d_chan.shape
    dev = d_chan.device
    out = d_chan.new_zeros((C, N))
    if N == 0 or C == 0:
        return out
    if threads % 32:
        raise ValueError("segment_rowsum_emulated: threads must be a multiple of 32")
    total = N + L
    tiles = -(-total // (threads * items))
    nt = tiles * threads
    start = torch.clamp(torch.arange(nt, device=dev) * items, max=total)
    i, j = merge_path_plain(keys, N, start)
    head_seg = i.clone()
    acc = d_chan.new_zeros((C, nt))
    head = d_chan.new_zeros((C, nt))
    emitted = torch.zeros(nt, dtype=torch.bool, device=dev)
    keys_l = keys.long()
    for k in range(items):
        live = start + k < total
        jc = j.clamp(max=max(L - 1, 0))
        later = (keys_l[jc] > i) if L else torch.ones_like(live)
        is_end = live & (i < N) & ((j >= L) | later)
        is_row = live & ~is_end
        if L:
            acc = torch.where(is_row, acc + d_chan[:, jc], acc)
        head = torch.where(is_end & ~emitted, acc, head)
        other = (is_end & emitted).nonzero().squeeze(1)
        out[:, i[other]] = acc[:, other]
        emitted |= is_end
        acc = torch.where(is_end, torch.zeros((), device=dev), acc)
        i, j = i + is_end, j + is_row
    # the segmented inclusive scan of the carries, block by block
    W = threads // 32
    v = acc.reshape(C, tiles, W, 32)
    s = i.reshape(tiles, W, 32)
    for off in (1, 2, 4, 8, 16):
        pv = torch.zeros_like(v)
        pv[..., off:] = v[..., :-off]
        ps = torch.full_like(s, -1)
        ps[..., off:] = s[..., :-off]
        v = torch.where(ps == s, pv + v, v)
    last_v, last_s = v[..., 31], s[..., 31]
    f = torch.zeros_like(last_v)  # f[..., w]: the scan at the last lane of warp w - 1
    run = last_v[..., 0]
    for w in range(1, W):
        f[..., w] = run
        run = torch.where(last_s[:, w] == last_s[:, w - 1], run + last_v[..., w], last_v[..., w])
    prev_s = torch.full_like(last_s, -1)
    prev_s[:, 1:] = last_s[:, :-1]
    v = torch.where(s == prev_s[..., None], f[..., None] + v, v).reshape(C, tiles, threads)
    before = torch.zeros_like(v)
    before[..., 1:] = v[..., :-1]
    local0 = (torch.arange(nt, device=dev) % threads == 0)
    hv = torch.where(local0, head, before.reshape(C, nt) + head)
    h = emitted.nonzero().squeeze(1)
    out[:, head_seg[h]] = hv[:, h]
    # across tiles, as segsum_fixup_kernel
    tile_seg = torch.cat([head_seg[::threads], head_seg.new_full((1,), N)]).cpu().numpy()
    bc = v[..., -1].cpu().numpy()
    fix_s, fix_x = [], []
    for b in range(1, tiles):
        sb = tile_seg[b]
        if sb >= N or tile_seg[b + 1] == sb:
            continue
        a = b - 1
        while a > 0 and tile_seg[a] == sb:
            a -= 1
        x = bc[:, a]
        for k in range(a + 1, b):
            x = x + bc[:, k]
        fix_s.append(int(sb))
        fix_x.append(x)
    if fix_s:
        idx = torch.as_tensor(fix_s, device=dev)
        x = torch.as_tensor(np.stack(fix_x, axis=1), device=dev)
        out[:, idx] = x + out[:, idx]
    return out


def segment_rowsum(
    d_chan: torch.Tensor,
    keys: torch.Tensor,
    offs: Optional[torch.Tensor] = None,
    ends: Optional[torch.Tensor] = None,
    *,
    num_segments: Optional[int] = None,
    skip_empty: bool = False,
) -> torch.Tensor:
    """Sum the rows of d_chan [C, L] into per-segment totals [C, N].
    skip_empty is accepted for the JAX signature: the kernel costs next
    to nothing on an empty segment either way."""
    del skip_empty
    if d_chan.device.type == "cpu":
        return segment_rowsum_plain(d_chan, keys, offs, ends, num_segments=num_segments)
    _build.require_cuda(d_chan, "segment_rowsum")
    N = _check_args(d_chan, keys, offs, ends, num_segments)
    d_chan = d_chan.contiguous()
    keys = keys.contiguous()
    C, L = d_chan.shape
    dev = d_chan.device
    lib = _build.load("segsum", _bind, BUILD_FLAGS)
    null = ctypes.c_void_p(None)
    bounds, scratch = [null, null], [null, null]
    if offs is not None:
        offs, ends = offs.contiguous(), ends.contiguous()
        bounds = [_build.ptr(offs), _build.ptr(ends)]
    else:
        if N + L >= 2**31 - 2**16:
            raise ValueError(f"segment_rowsum: {N} segments + {L} rows >= 2**31 - 2**16")
        tiles = -(-(N + L) // lib.segment_rowsum_tile_items())
        carry = torch.empty(tiles * C, dtype=torch.float32, device=dev)
        tile_seg = torch.empty(tiles + 1, dtype=torch.int32, device=dev)
        scratch = [_build.ptr(carry), _build.ptr(tile_seg)]
    out = torch.empty((C, N), dtype=torch.float32, device=dev)
    err = lib.segment_rowsum_f32(
        _build.ptr(d_chan), _build.ptr(keys), *bounds,
        _build.ptr(out), C, L, N, *scratch, _build.stream_of(d_chan),
    )
    _build.check(err, "segment_rowsum")
    segment_rowsum.launches += 1
    return out


segment_rowsum.launches = 0
