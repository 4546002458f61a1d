"""Build and load the port's CUDA kernels.

Each source in `csrc/` is compiled by its own `nvcc` process into a shared
library with a plain C interface and loaded with `ctypes` (no PyTorch
headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o _build/<name>-<hash>.so csrc/<name>.cu

The library name carries a hash of the source and flags, so an edited
source is rebuilt and a stale library is never loaded.  Builds happen at
first use (or all at once, in parallel, through `build_all`), never when a
module is imported; the build directory `kernels/_build/` is git-ignored.
Every C entry point returns `cudaGetLastError()` after its launch.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).parent / "csrc"
BUILD_DIR = Path(__file__).parent / "_build"
SOURCES = ("unpack", "intersect")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_VP = ctypes.c_void_p
_LL = ctypes.c_longlong
# C signatures: pointers and the stream are c_void_p, sizes are 64-bit
SIGNATURES = {
    "unpack": ("unpack_postings_launch",
               (_VP, _LL, _VP, _LL, _VP, _LL, _VP, _VP, _VP, _VP)),
    "intersect": ("banded_intersect_rows_launch",
                  (_VP, _VP, _VP, _LL, _LL, _LL, _VP, _VP)),
}


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return path


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:12]}.so"


def _start_build(name: str):
    """Start one nvcc into a temporary file; returns (Popen, tmp, target)
    or None when the library is already built."""
    target = library_path(name)
    if target.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, target


def _finish_build(name: str, job) -> str:
    proc, tmp, target = job
    out, _ = proc.communicate()
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{out}")
    os.replace(tmp, target)      # atomic: concurrent builders never see half
    return out


def build_all() -> dict:
    """Compile every kernel source at once, one nvcc each; returns the
    compiler's output per source ('' when it was already built)."""
    jobs = {name: _start_build(name) for name in SOURCES}
    return {name: (_finish_build(name, job) if job is not None else "")
            for name, job in jobs.items()}


@functools.lru_cache(maxsize=None)
def load(name: str):
    """The C entry point of kernel source `name`, building it if needed."""
    job = _start_build(name)
    if job is not None:
        _finish_build(name, job)
    lib = ctypes.CDLL(str(library_path(name)))
    fn_name, argtypes = SIGNATURES[name]
    fn = getattr(lib, fn_name)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def check(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
