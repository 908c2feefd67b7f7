"""Process groups for the parallel modes (parallel/dp.py, parallel/tiles.py,
parallel/gauss.py).

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

Hosts: a rank's host (`Group.node`) is rank // local_size, where
local_size is torchrun's LOCAL_WORLD_SIZE (or init_group's
local_world_size: the tests emulate two hosts of one rank each on one
machine): the port's form of the JAX package's multi-host runtime
(its parallel/dp.py init_multihost). `Group.split` builds the 2D layouts
of the Gaussian-sharded modes: a [B, G] mesh of the group's ranks, host
major, whose rows are the gauss sub-groups (the G ranks of one camera,
inside one host when the mesh is picked per host) and whose columns are
the data sub-groups (the ranks holding the same row block, one a
camera).

The collectives the parallel steps need:
  * `Group.all_reduce`: sum, mean or max of a list of tensors, one
    flattened buffer per dtype;
  * `Group.broadcast`: rank 0's tensors on every rank;
  * `Group.gather_rows`: the rows of every rank's tensor in rank order,
    differentiable: its backward is the reduce-scatter of the cotangent
    (an all_reduce of the whole cotangent and this rank's rows of it:
    the same sums, through the collective every backend has);
  * `Group.gather_rows_many`: the same for a list of per-row tensors,
    one flattened buffer a dtype; the floating part is differentiable,
    the integer and bool parts carry no gradient.
"""

from __future__ import annotations

import dataclasses
import datetime
import math
import os
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

TIMEOUT_S = 300


def log(msg: str) -> None:
    print(f"[comm] {msg}", flush=True)


def choose_backend(device: torch.device, ranks_per_machine: int) -> str:
    """NCCL when `device` is a CUDA card and the machine has one for each
    of its ranks_per_machine ranks; Gloo otherwise."""
    if device.type == "cuda" and dist.is_nccl_available() and torch.cuda.device_count() >= ranks_per_machine:
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
    """A process group: this rank, the size, the backend and this rank's
    device; `pg` the torch.distributed group (None: the default, world
    group), `ranks` its members' global ranks in group order (None: 0 ..
    size - 1) and `hosts` the host of each member (None: one host)."""

    rank: int
    size: int
    backend: str
    device: torch.device
    pg: Optional[object] = None
    ranks: Optional[Tuple[int, ...]] = None
    hosts: Optional[Tuple[int, ...]] = None
    # bytes this rank has put into each kind of collective (an all_gather
    # brings it size - 1 times as many)
    traffic: Dict[str, int] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if self.ranks is None:
            self.ranks = tuple(range(self.size))
        if self.hosts is None:
            self.hosts = (0,) * self.size
        nodes = sorted(set(self.hosts))
        per = [self.hosts.count(h) for h in nodes]
        if len(set(per)) != 1 or list(self.hosts) != sorted(self.hosts):
            raise ValueError(f"a group's ranks must be host-major with as many on every host: hosts {self.hosts}")

    @property
    def local_size(self) -> int:
        """Ranks of this group on each host."""
        return self.hosts.count(self.hosts[self.rank])

    @property
    def local_rank(self) -> int:
        return self.rank % self.local_size

    @property
    def node(self) -> int:
        """This rank's host, 0 .. nodes - 1."""
        return self.rank // self.local_size

    @property
    def nodes(self) -> int:
        return self.size // self.local_size

    def all_reduce(self, tensors: Sequence[torch.Tensor], op: str) -> List[torch.Tensor]:
        """op ("sum", "mean" or "max") of each tensor over the group; the
        tensors of one dtype travel in one flattened buffer. Every rank
        gets the same bits."""
        red = {"sum": dist.ReduceOp.SUM, "mean": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
        out: List[Optional[torch.Tensor]] = [None] * len(tensors)
        for dtype, idx in _by_dtype(tensors).items():
            parts = [tensors[i].detach().reshape(-1) for i in idx]
            buf = torch.cat(parts) if len(parts) > 1 else parts[0].clone()
            self._count("all_reduce", buf)
            dist.all_reduce(buf, op=red, group=self.pg)
            if op == "mean":
                buf = buf / self.size
            for i, piece in zip(idx, torch.split(buf, [p.numel() for p in parts])):
                out[i] = piece.reshape(tensors[i].shape)
        return out

    def broadcast(self, tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """The group's rank 0's tensors on every rank (bool travels as
        uint8), one flattened buffer per dtype."""
        out: List[Optional[torch.Tensor]] = [None] * len(tensors)
        for dtype, idx in _by_dtype(tensors).items():
            parts = [tensors[i].detach().reshape(-1) for i in idx]
            buf = torch.cat(parts)
            if dtype == torch.bool:
                buf = buf.to(torch.uint8)
            self._count("broadcast", buf)
            dist.broadcast(buf, src=self.ranks[0], group=self.pg)
            for i, piece in zip(idx, torch.split(buf.to(dtype), [p.numel() for p in parts])):
                out[i] = piece.reshape(tensors[i].shape)
        return out

    def all_gather(self, x: torch.Tensor) -> List[torch.Tensor]:
        """Every rank's x (same shape on every rank), in rank order."""
        src = x.detach().contiguous()
        wire = src.to(torch.uint8) if src.dtype == torch.bool else src
        parts = [torch.empty_like(wire) for _ in range(self.size)]
        self._count("all_gather", wire)
        dist.all_gather(parts, wire, group=self.pg)
        return [p.to(src.dtype) for p in parts] if wire is not src else parts

    def _count(self, op: str, buf: torch.Tensor) -> None:
        self.traffic[op] = self.traffic.get(op, 0) + buf.numel() * buf.element_size()

    def gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """torch.cat of every rank's x along dim 0, in rank order, with the
        reduce-scatter of the cotangent as its gradient."""
        return self.gather_rows_many([x])[0]

    def gather_rows_many(self, tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """gather_rows of each tensor (every one with the same rows on this
        rank), one flattened buffer a dtype: the floating tensors through
        one differentiable gather (its backward one reduce-scatter), the
        others without gradient."""
        out: List[Optional[torch.Tensor]] = [None] * len(tensors)
        for dtype, idx in _by_dtype(tensors).items():
            parts = [tensors[i] for i in idx]
            if dtype.is_floating_point:
                got = _GatherRowsMany.apply(self, *parts)
            else:
                with torch.no_grad():
                    got = _gather_rows_flat(self, [p.detach() for p in parts])
            for i, g in zip(idx, got):
                out[i] = g
        return out

    def split(self, gauss: int, data_per_node: Optional[int] = None):
        """The [B, gauss] mesh of this group's ranks (B = size // gauss),
        rows the gauss sub-groups, columns the data sub-groups: returns
        (this rank's gauss sub-group, its data sub-group), None where a
        sub-group would be one rank (a gauss group of the whole group is
        the group itself). data_per_node: the mesh takes data_per_node
        cameras of gauss ranks on every host, host-major (the JAX
        package's make_multihost_mesh), so that a gauss group never
        spans hosts; the group must hold exactly those ranks. Every rank
        creates every sub-group, in the same order."""
        if gauss < 1 or self.size % gauss:
            raise RuntimeError(f"{self.size} ranks cannot form gauss groups of {gauss}")
        if data_per_node is not None and data_per_node * gauss != self.local_size:
            raise RuntimeError(f"multi-host gauss x DP needs {data_per_node * gauss} devices per process, "
                               f"have {self.local_size}")
        B = self.size // gauss
        if gauss == 1:
            return None, (self if B > 1 else None)
        if B == 1:
            return self, None
        g_group = d_group = None
        for b in range(B):
            g_group = self.subgroup(list(range(b * gauss, (b + 1) * gauss))) or g_group
        for g in range(gauss):
            d_group = self.subgroup([b * gauss + g for b in range(B)]) or d_group
        return g_group, d_group

    def subgroup(self, members: List[int]) -> Optional["Group"]:
        """The sub-group of `members` (group ranks): new_group on every
        rank; a Group on its members, None elsewhere."""
        global_ranks = [self.ranks[m] for m in members]
        pg = dist.new_group(ranks=global_ranks, timeout=datetime.timedelta(seconds=TIMEOUT_S))
        if self.rank not in members:
            return None
        return Group(rank=members.index(self.rank), size=len(members), backend=self.backend, device=self.device,
                     pg=pg, ranks=tuple(global_ranks), hosts=tuple(self.hosts[m] for m in members))


def _by_dtype(tensors: Sequence[torch.Tensor]) -> dict:
    by = {}
    for i, t in enumerate(tensors):
        by.setdefault(t.dtype, []).append(i)
    return by


def _gather_rows_flat(group: Group, parts: List[torch.Tensor]) -> List[torch.Tensor]:
    """Every rank's rows of each part (same dtype, same rows), in rank
    order, through one all_gather of a [rows, sum of widths] buffer."""
    rows = parts[0].shape[0]
    widths = [math.prod(p.shape[1:]) for p in parts]
    buf = torch.cat([p.reshape(rows, -1) for p in parts], dim=1)
    full = torch.cat(group.all_gather(buf), dim=0)
    return [piece.reshape((group.size * rows,) + tuple(p.shape[1:]))
            for piece, p in zip(torch.split(full, widths, dim=1), parts)]


class _GatherRowsMany(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group: Group, *parts):
        ctx.group = group
        ctx.shapes = [p.shape for p in parts]
        return tuple(_gather_rows_flat(group, [p.detach() for p in parts]))

    @staticmethod
    def backward(ctx, *grads):
        group = ctx.group
        rows = ctx.shapes[0][0]
        full = [torch.zeros((group.size * rows,) + tuple(s[1:]), device=group.device) if g is None else g
                for g, s in zip(grads, ctx.shapes)]
        widths = [math.prod(s[1:]) for s in ctx.shapes]
        buf = torch.cat([f.reshape(group.size * rows, -1) for f in full], dim=1).contiguous()
        buf = group.all_reduce([buf], "sum")[0]
        mine = buf[group.rank * rows:(group.rank + 1) * rows]
        return (None, *(piece.reshape(s) for piece, s in zip(torch.split(mine, widths, dim=1), ctx.shapes)))


def init_group(rank: Optional[int] = None, world_size: Optional[int] = None, init_method: Optional[str] = None,
               device=None, local_world_size: Optional[int] = None) -> Group:
    """Form the default process group and return it as a Group.

    With rank None, from torchrun's environment: RANK, WORLD_SIZE,
    LOCAL_RANK, LOCAL_WORLD_SIZE, GROUP_RANK (the host) and init_method
    env://. Otherwise from the explicit rank, world_size and init_method
    (file://... or tcp://localhost:PORT), every rank on this machine, in
    hosts of local_world_size ranks (default: one host), so that one
    machine can stand for several hosts. The rank's device is
    `rank_device`. Ranks of several hosts on one machine (an explicit
    init method, or MASTER_ADDR a loopback address) count as sharing its
    cards when the backend is chosen. A group that does not form raises;
    nothing falls back to one process."""
    if rank is None:
        rank = int(os.environ["RANK"])
        world_size = int(os.environ["WORLD_SIZE"])
        local_rank = int(os.environ.get("LOCAL_RANK", rank))
        local_world_size = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
        host = int(os.environ.get("GROUP_RANK", rank // local_world_size))
        init_method = "env://"
        one_machine = os.environ.get("MASTER_ADDR", "") in ("127.0.0.1", "localhost", "::1")
    else:
        if world_size is None or init_method is None:
            raise ValueError("an explicit rank needs world_size and init_method")
        local_world_size = local_world_size or world_size
        if world_size % local_world_size:
            raise ValueError(f"{world_size} ranks do not split into hosts of {local_world_size}")
        local_rank, host, one_machine = rank % local_world_size, rank // local_world_size, True
    dev = rank_device(local_rank, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    here = world_size if one_machine else local_world_size
    backend = choose_backend(dev, here)
    why = ("one card a rank" if backend == "nccl" else
           "CPU tensors" if dev.type != "cuda" else
           f"{here} ranks share {torch.cuda.device_count()} card(s): NCCL refuses two ranks on one")
    log(f"rank {rank}/{world_size} (host {host}, local rank {local_rank}/{local_world_size}) on {dev}: "
        f"backend {backend} ({why})")
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world_size,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    mine = torch.tensor([host], device=dev if backend == "nccl" else "cpu")
    hosts = [torch.empty_like(mine) for _ in range(world_size)]
    dist.all_gather(hosts, mine)
    return Group(rank=rank, size=world_size, backend=backend, device=dev, hosts=tuple(int(h) for h in hosts))


def close_group() -> None:
    """Destroy the default process group, when there is one."""
    if dist.is_initialized():
        dist.destroy_process_group()
