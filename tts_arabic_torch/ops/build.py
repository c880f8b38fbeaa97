"""Builds the port's CUDA kernels with nvcc and loads them through ctypes.

Every `csrc/*.cu` source is compiled for `sm_90a` into one shared library
with a plain C interface, at first use, into `build/` beside the package
(git-ignored). The library's name carries a hash of the sources and the
flags, so an edited source is rebuilt and a stale library is never loaded.
Nothing here runs at import time: the CPU-only test suite imports every
module on a machine that has no nvcc.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_lib = None
build_log = ""        # nvcc's output (ptxas registers / spills) of the build
build_seconds = 0.0   # 0.0 when the library was already built


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH): "
                       "the CUDA kernels cannot be built")


def _sources() -> list[pathlib.Path]:
    srcs = sorted(CSRC.glob("*.cu"))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    return srcs


def library() -> ctypes.CDLL:
    """The kernels' shared library, built on first call."""
    global _lib, build_log, build_seconds
    with _lock:
        if _lib is not None:
            return _lib
        srcs = _sources()
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for s in srcs:
            h.update(s.name.encode())
            h.update(s.read_bytes())
        out = BUILD_DIR / f"libtts_kernels_{h.hexdigest()[:16]}.so"
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, srcs)]
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, capture_output=True, text=True)
            build_seconds = time.perf_counter() - t0
            build_log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                                   f"{build_log}")
            os.replace(tmp, out)
        lib = ctypes.CDLL(str(out))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.resblock1_pass.argtypes = [p] * 6 + [i] * 7 + [p]
        lib.resblock1_pass.restype = i
        lib.resblock1_fused.argtypes = [p] * 6 + [i] * 10 + [p]
        lib.resblock1_fused.restype = i
        _lib = lib
        return lib
