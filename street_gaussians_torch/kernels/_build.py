"""Build and load the hand-written CUDA kernels (`csrc/*.cu`).

Each source compiles with nvcc into its own shared library with a plain
C interface under `street_gaussians_torch/_build/`, on first use, and is
loaded with ctypes. Nothing builds at import time. `build` compiles
several sources at once, one nvcc process per source. A library's file
name carries a hash of its source text, of the headers under `csrc/`
(`*.cuh`) and of its nvcc flags, so a change to any of them builds a new
library instead of loading a stale one. `load(..., extra_flags=...)`
builds a variant of a source (a probe build with a `-D` macro) beside
the shipped library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Callable, Dict, Iterable, Sequence

import torch

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")

ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
# per-source flags: the blend rounds every product and sum on its own,
# as its plain PyTorch version does, so the two differ only in the
# order of their sums; so do binning's corner cull (fill), so the two
# decide every edge alike, and Adam, so that it is bit-equal to its
# plain version
EXTRA_FLAGS = {
    name: ["-fmad=false"]
    for name in ("fill", "tile_blend", "tile_blend_bwd", "tile_blend_table", "tile_blend_table_bwd", "probe_blend",
                 "adam")
}
# every source under csrc/, for a caller that builds them all at once
ALL_SOURCES = (
    "fill", "tile_blend", "tile_blend_bwd", "segsum",
    "tile_blend_table", "tile_blend_table_bwd", "probe_blend", "adam", "sh_color",
)

_LIBS: Dict[tuple, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def source_path(name: str) -> str:
    return os.path.join(CSRC_DIR, f"{name}.cu")


def nvcc_flags(name: str, extra_flags: Sequence[str] = ()) -> list:
    return [
        *ARCH_FLAGS, "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
        "-Xptxas", "-v", *EXTRA_FLAGS.get(name, []), *extra_flags,
    ]


def library_name(source: bytes, name: str, flags) -> str:
    """lib<name>-<hash>.so, the hash over the source text and the flags."""
    h = hashlib.sha256(source)
    h.update("\0".join(flags).encode())
    return f"lib{name}-{h.hexdigest()[:16]}.so"


def source_bytes(name: str) -> bytes:
    """The text a library is built from: its source, then every header
    under csrc/ (a source may include any of them)."""
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    text = b""
    for path in [source_path(name), *(os.path.join(CSRC_DIR, h) for h in headers)]:
        with open(path, "rb") as f:
            text += f.read() + b"\0"
    return text


def library_path(name: str, extra_flags: Sequence[str] = ()) -> str:
    flags = nvcc_flags(name, extra_flags)
    return os.path.join(BUILD_DIR, library_name(source_bytes(name), name, flags))


def build(names: Iterable[str], extra_flags: Sequence[str] = ()) -> Dict[str, dict]:
    """Compile the named sources that are missing or stale, all nvcc
    processes started together. Returns {name: {"seconds", "log"}} for
    the sources it compiled (the log holds ptxas's register and shared
    memory report). Raises with nvcc's output when a build fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = None
    running = {}
    for name in names:
        so = library_path(name, extra_flags)
        if os.path.exists(so):
            continue
        nvcc = nvcc or _nvcc()
        tmp = f"{so}.{os.getpid()}.tmp"
        cmd = [nvcc, *nvcc_flags(name, extra_flags), "-o", tmp, source_path(name)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        running[name] = (proc, so, tmp, time.perf_counter())
    done = {}
    for name, (proc, so, tmp, t0) in running.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{log.decode()}")
        os.replace(tmp, so)
        done[name] = {"seconds": time.perf_counter() - t0, "log": log.decode()}
    return done


def load(name: str, bind: Callable[[ctypes.CDLL], None], extra_flags: Sequence[str] = ()) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built on first use.
    `bind` declares argtypes/restype of its entry points. `extra_flags`
    names a variant of the source (more nvcc flags), built and kept
    beside the shipped library."""
    key = (name, *extra_flags)
    with _LOCK:
        lib = _LIBS.get(key)
        if lib is None:
            build([name], extra_flags)
            lib = ctypes.CDLL(library_path(name, extra_flags))
            bind(lib)
            _LIBS[key] = lib
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
