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

`segment_rowsum` runs the plain PyTorch version for a CPU tensor and the
kernel for a CUDA tensor.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from street_gaussians_torch.kernels import _build

BIG = 1 << 30  # key of padding rows (falls in no segment)


def _bind(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.segment_rowsum_f32.argtypes = [p, p, p, p, p, i, ctypes.c_long, i, p]
    lib.segment_rowsum_f32.restype = ctypes.c_int


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
    """Plain PyTorch version: the kernel's row ranges by searchsorted,
    then `index_add_` (on the CPU in row order, the kernel's order)."""
    N = _check_args(d_chan, keys, offs, ends, num_segments)
    out = d_chan.new_zeros((d_chan.shape[0], N))
    if N == 0 or d_chan.shape[1] == 0:
        return out
    seg, row = segment_rows(keys, offs, ends, N)
    return out.index_add_(1, seg, d_chan[:, row])


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
    bounds = [ctypes.c_void_p(None)] * 2
    if offs is not None:
        offs, ends = offs.contiguous(), ends.contiguous()
        bounds = [_build.ptr(offs), _build.ptr(ends)]
    C, L = d_chan.shape
    out = torch.empty((C, N), dtype=torch.float32, device=d_chan.device)
    lib = _build.load("segsum", _bind)
    err = lib.segment_rowsum_f32(
        _build.ptr(d_chan), _build.ptr(keys), *bounds,
        _build.ptr(out), C, L, N, _build.stream_of(d_chan),
    )
    _build.check(err, "segment_rowsum")
    segment_rowsum.launches += 1
    return out


segment_rowsum.launches = 0
