"""Process groups for the parallel modes (parallel/dp.py, parallel/tiles.py).

The JAX package runs its parallel modes as `shard_map` over a device
mesh; the port runs them as ranks of a torch.distributed process group,
one process a rank. A group forms from torchrun's environment (RANK,
WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE, MASTER_ADDR, MASTER_PORT) or
from an explicit (rank, world_size, init_method), as the tests spawn
their ranks.

The backend is chosen once, by `choose_backend`, and logged:
  * NCCL when every rank of the host has a CUDA card of its own;
  * Gloo otherwise: on the CPU, and for ranks that share one card (NCCL
    refuses two ranks on one device).
No collective switches backends after a failure. Gloo takes the ranks'
CUDA tensors as they are in all_reduce, broadcast and all_gather (on
torch 2.11 with CUDA 12.8), so no collective is staged through the host
here.

The collectives the parallel steps need:
  * `Group.all_reduce`: sum, mean or max of a list of tensors, one
    flattened buffer per dtype;
  * `Group.broadcast`: rank 0's tensors on every rank;
  * `Group.gather_rows`: the rows of every rank's tensor in rank order,
    differentiable: its backward is the reduce-scatter of the cotangent
    (an all_reduce of the whole cotangent and this rank's rows of it:
    the same sums, through the collective every backend has).
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

TIMEOUT_S = 300


def log(msg: str) -> None:
    print(f"[comm] {msg}", flush=True)


def choose_backend(device: torch.device, local_world_size: int) -> str:
    """NCCL when `device` is a CUDA card and the host has one for each of
    its local_world_size ranks; Gloo otherwise."""
    if device.type == "cuda" and dist.is_nccl_available() and torch.cuda.device_count() >= local_world_size:
        return "nccl"
    return "gloo"


def rank_device(local_rank: int, device=None) -> torch.device:
    """The device of a rank: `device` when given, else cuda:LOCAL_RANK, or
    cuda:0 when the host has one card (its ranks share it). Raises where
    there is no card to put the rank on."""
    if device is not None:
        return torch.device(device)
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise RuntimeError("CUDA is not available; pass device='cpu' to run the ranks on the CPU")
    if n == 1:
        return torch.device("cuda", 0)
    if local_rank >= n:
        raise RuntimeError(f"local rank {local_rank} has no card of its own ({n} cards)")
    return torch.device("cuda", local_rank)


@dataclasses.dataclass
class Group:
    """The default (world) process group: this rank, the size, the
    backend and this rank's device."""

    rank: int
    size: int
    backend: str
    device: torch.device

    def all_reduce(self, tensors: Sequence[torch.Tensor], op: str) -> List[torch.Tensor]:
        """op ("sum", "mean" or "max") of each tensor over the group; the
        tensors of one dtype travel in one flattened buffer. Every rank
        gets the same bits."""
        red = {"sum": dist.ReduceOp.SUM, "mean": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
        out: List[Optional[torch.Tensor]] = [None] * len(tensors)
        by_dtype = {}
        for i, t in enumerate(tensors):
            by_dtype.setdefault(t.dtype, []).append(i)
        for dtype, idx in by_dtype.items():
            parts = [tensors[i].detach().reshape(-1) for i in idx]
            buf = torch.cat(parts) if len(parts) > 1 else parts[0].clone()
            dist.all_reduce(buf, op=red)
            if op == "mean":
                buf = buf / self.size
            for i, piece in zip(idx, torch.split(buf, [p.numel() for p in parts])):
                out[i] = piece.reshape(tensors[i].shape)
        return out

    def broadcast(self, tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Rank 0's tensors on every rank (bool travels as uint8), one
        flattened buffer per dtype."""
        out: List[Optional[torch.Tensor]] = [None] * len(tensors)
        by_dtype = {}
        for i, t in enumerate(tensors):
            by_dtype.setdefault(t.dtype, []).append(i)
        for dtype, idx in by_dtype.items():
            parts = [tensors[i].detach().reshape(-1) for i in idx]
            buf = torch.cat(parts)
            if dtype == torch.bool:
                buf = buf.to(torch.uint8)
            dist.broadcast(buf, src=0)
            for i, piece in zip(idx, torch.split(buf.to(dtype), [p.numel() for p in parts])):
                out[i] = piece.reshape(tensors[i].shape)
        return out

    def all_gather(self, x: torch.Tensor) -> List[torch.Tensor]:
        """Every rank's x (same shape on every rank), in rank order."""
        src = x.detach().contiguous()
        parts = [torch.empty_like(src) for _ in range(self.size)]
        dist.all_gather(parts, src)
        return parts

    def gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """torch.cat of every rank's x along dim 0, in rank order, with the
        reduce-scatter of the cotangent as its gradient."""
        return _GatherRows.apply(x, self)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group: Group):
        ctx.group = group
        ctx.rows = x.shape[0]
        return torch.cat(group.all_gather(x), dim=0)

    @staticmethod
    def backward(ctx, g):
        g = ctx.group.all_reduce([g.contiguous()], "sum")[0]
        r0 = ctx.group.rank * ctx.rows
        return g[r0:r0 + ctx.rows], None


def init_group(rank: Optional[int] = None, world_size: Optional[int] = None, init_method: Optional[str] = None,
               device=None) -> Group:
    """Form the default process group and return it as a Group.

    With rank None, from torchrun's environment: RANK, WORLD_SIZE,
    LOCAL_RANK, LOCAL_WORLD_SIZE and init_method env://. Otherwise from
    the explicit rank, world_size and init_method (file://... or
    tcp://localhost:PORT), every rank on this host. The rank's device is
    `rank_device`. A group
    that does not form raises; nothing falls back to one process."""
    if rank is None:
        rank = int(os.environ["RANK"])
        world_size = int(os.environ["WORLD_SIZE"])
        local_rank = int(os.environ.get("LOCAL_RANK", rank))
        local_world_size = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
        init_method = "env://"
    else:
        if world_size is None or init_method is None:
            raise ValueError("an explicit rank needs world_size and init_method")
        local_rank, local_world_size = rank, world_size
    dev = rank_device(local_rank, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    backend = choose_backend(dev, local_world_size)
    why = ("one card a rank" if backend == "nccl" else
           "CPU tensors" if dev.type != "cuda" else
           f"{local_world_size} ranks share {torch.cuda.device_count()} card(s): NCCL refuses two ranks on one")
    log(f"rank {rank}/{world_size} on {dev}: backend {backend} ({why})")
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world_size,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    return Group(rank=rank, size=world_size, backend=backend, device=dev)


def close_group() -> None:
    """Destroy the default process group, when there is one."""
    if dist.is_initialized():
        dist.destroy_process_group()
