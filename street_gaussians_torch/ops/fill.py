"""Run expansion (kernel A): per-gaussian values to per-instance slots.

Gaussian j owns the contiguous slot run [offs[j], offs[j+1]) (the last
run ends at `total`), so

    out[:, s] = vals[:, j]   for the unique j with offs[j] <= s < offs[j+1]

and 0 for slots no run covers, at and beyond `total` included.

Replaces street_gaussians_tpu/ops/fill.py::_kernel (an MXU select
matmul on the TPU) with `csrc/fill.cu`: one thread per output slot,
which binary-searches the run ends for its owner. Bound on the H100:
memory (read vals [C, N], write out [C, S]); the copy is exact and
deterministic, and the work is even however ragged the runs are.

`expand_runs` runs the plain PyTorch version for a CPU tensor and the
kernel for a CUDA tensor.
"""

from __future__ import annotations

import ctypes

import torch

from street_gaussians_torch.kernels import _build


def _bind(lib: ctypes.CDLL) -> None:
    p = ctypes.c_void_p
    lib.expand_runs_f32.argtypes = [p, p, p, p, ctypes.c_int, ctypes.c_int, ctypes.c_int, p]
    lib.expand_runs_f32.restype = ctypes.c_int


def _check_args(vals, offs, total, num_slots):
    if vals.dim() != 2 or vals.dtype != torch.float32:
        raise ValueError(f"expand_runs: vals must be [C, N] float32, got {tuple(vals.shape)} {vals.dtype}")
    C, N = vals.shape
    if offs.shape != (N,) or offs.dtype != torch.int32:
        raise ValueError(f"expand_runs: offs must be [{N}] int32, got {tuple(offs.shape)} {offs.dtype}")
    if total.numel() != 1 or total.dtype != torch.int32:
        raise ValueError("expand_runs: total must be a scalar int32 tensor")
    if offs.device != vals.device or total.device != vals.device:
        raise ValueError("expand_runs: vals, offs and total must share a device")
    if N >= 2**24:
        # the JAX op routes integer channels (gaussian ids, packed rects)
        # through f32, exact only below 2^24; the port keeps its contract
        raise ValueError(
            f"expand_runs: {N} runs >= 2**24 — integer channels carried "
            "as f32 would round; shard the gaussian axis below 2^24"
        )
    if num_slots < 0:
        raise ValueError("expand_runs: num_slots must be >= 0")


def expand_runs_plain(
    vals: torch.Tensor, offs: torch.Tensor, total: torch.Tensor, num_slots: int
) -> torch.Tensor:
    """Plain PyTorch version: searchsorted over the run ends, then a
    gather. Same contract as `expand_runs`."""
    C, N = vals.shape
    s = torch.arange(num_slots, dtype=torch.int32, device=vals.device)
    if N == 0:
        return vals.new_zeros((C, num_slots))
    ends = torch.cat([offs[1:], total.reshape(1).to(offs.dtype)])
    j = torch.searchsorted(ends, s, right=True)
    jc = j.clamp(max=N - 1)
    hit = (j < N) & (offs[jc] <= s)
    return torch.where(hit[None, :], vals[:, jc], vals.new_zeros(()))


def expand_runs(
    vals: torch.Tensor, offs: torch.Tensor, total: torch.Tensor, num_slots: int
) -> torch.Tensor:
    """vals: [C, N] f32 channel-major per-gaussian values (integer
    channels pre-converted to f32, exact below 2^24). offs: [N] int32
    non-decreasing run starts (exclusive cumsum of per-gaussian counts;
    zero-count gaussians give empty runs). total: scalar int32 tensor =
    offs[-1] + cnt[-1]. Returns [C, num_slots] f32."""
    _check_args(vals, offs, total, num_slots)
    if vals.device.type == "cpu":
        return expand_runs_plain(vals, offs, total, num_slots)
    _build.require_cuda(vals, "expand_runs")
    vals = vals.contiguous()
    offs = offs.contiguous()
    total = total.reshape(()).contiguous()
    C, N = vals.shape
    out = torch.empty((C, num_slots), dtype=torch.float32, device=vals.device)
    lib = _build.load("fill", _bind)
    err = lib.expand_runs_f32(
        _build.ptr(vals), _build.ptr(offs), _build.ptr(total), _build.ptr(out),
        C, N, num_slots, _build.stream_of(vals),
    )
    _build.check(err, "expand_runs")
    expand_runs.launches += 1
    return out


expand_runs.launches = 0
