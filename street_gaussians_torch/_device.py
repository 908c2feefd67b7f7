"""Device resolution for the port's entry points."""

from __future__ import annotations

import time
from typing import Callable

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: `device` when given, else the
    current CUDA card. Raises when no device was asked for and CUDA is
    absent: the port never falls back to the CPU on its own."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return torch.device("cuda", torch.cuda.current_device())


def time_ms(fn: Callable[[], object], iters: int, device: torch.device) -> float:
    """Mean ms of fn() over `iters` calls after one warm-up call: CUDA
    events on a card, the host clock on the CPU."""
    fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) * 1e3 / iters
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(device)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / iters


def graph_ms(fn: Callable[[], object], iters: int, device: torch.device) -> float:
    """Mean device ms of fn() on a CUDA card with the host's launch cost
    taken out: `iters` calls captured into one CUDA graph (after a
    warm-up call on a side stream), its replay timed by CUDA events."""
    if device.type != "cuda":
        raise ValueError("graph_ms times CUDA work only")
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream(device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(device)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / iters
