"""Build and load the hand-written CUDA kernels (`csrc/*.cu`).

Each source compiles with nvcc into its own shared library with a plain
C interface under `street_gaussians_torch/_build/`, on first use, and is
loaded with ctypes. Nothing builds at import time. `build` compiles
several sources at once, one nvcc process per source.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
from typing import Callable, Dict, Iterable

import torch

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")

ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
# per-source flags: the blend rounds every product and sum on its own,
# as its plain PyTorch version does, so the two differ only in the
# order of their sums
EXTRA_FLAGS = {"tile_blend": ["-fmad=false"]}

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def source_path(name: str) -> str:
    return os.path.join(CSRC_DIR, f"{name}.cu")


def library_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}.so")


def _up_to_date(name: str) -> bool:
    so = library_path(name)
    return os.path.exists(so) and os.path.getmtime(so) >= os.path.getmtime(
        source_path(name)
    )


def build(names: Iterable[str]) -> Dict[str, dict]:
    """Compile the named sources that are missing or stale, all nvcc
    processes started together. Returns {name: {"seconds", "log"}} for
    the sources it compiled (the log holds ptxas's register and shared
    memory report). Raises with nvcc's output when a build fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = None
    running = {}
    for name in names:
        if _up_to_date(name):
            continue
        nvcc = nvcc or _nvcc()
        tmp = f"{library_path(name)}.{os.getpid()}.tmp"
        cmd = [
            nvcc, *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
            "-Xcompiler", "-fPIC", "-Xptxas", "-v",
            *EXTRA_FLAGS.get(name, []), "-o", tmp, source_path(name),
        ]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        running[name] = (proc, tmp, time.perf_counter())
    done = {}
    for name, (proc, tmp, t0) in running.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{log.decode()}")
        os.replace(tmp, library_path(name))
        done[name] = {"seconds": time.perf_counter() - t0, "log": log.decode()}
    return done


def load(name: str, bind: Callable[[ctypes.CDLL], None]) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built on first use.
    `bind` declares argtypes/restype of its entry points."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(library_path(name))
            bind(lib)
            _LIBS[name] = lib
        return lib


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_of(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def check(err: int, name: str) -> None:
    """Raise when a C entry point reports a CUDA error (it returns
    cudaGetLastError() right after its launch)."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def require_cuda(t: torch.Tensor, name: str) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CPU or CUDA tensor, got {t.device}")
