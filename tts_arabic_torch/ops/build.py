"""Builds the port's CUDA kernels with nvcc and loads them through ctypes.

Every `csrc/*.cu` source is compiled for `sm_90a` at first use, one `nvcc`
process per source, all started together, and the objects are linked into
one shared library with a plain C interface in `build/` beside the package
(git-ignored). The library's name carries a hash of the sources and the
flags, so an edited source is rebuilt and a stale library is never loaded.
Nothing here runs at import time: the CPU-only test suite imports every
module on a machine that has no nvcc.

`host_library` builds a host C++ source of `csrc/` (`*.cc`, no CUDA) with
the host compiler into its own library in `build/`, named the same way;
it runs wherever a C++ compiler does, the CPU-only machine included.
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
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# no -ffast-math: the sums keep their order (float32, index order)
CXX_FLAGS = ("-std=c++17", "-O3", "-fPIC", "-shared", "-Wall")

_lock = threading.Lock()
_lib = None
_host_libs = {}
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


def _hashed(stem: str, flags, srcs) -> pathlib.Path:
    """build/<stem>_<hash of the flags and sources>.so"""
    h = hashlib.sha256(" ".join(flags).encode())
    for s in srcs:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    return BUILD_DIR / f"{stem}_{h.hexdigest()[:16]}.so"


def _cxx() -> str:
    path = shutil.which("c++")
    if path is None:
        raise RuntimeError("no host C++ compiler: `c++` is not on PATH, so "
                           "the host libraries cannot be built")
    return path


def host_library(name: str) -> ctypes.CDLL:
    """The library of the host source `csrc/<name>.cc`, built on first
    call with the host compiler (CXX_FLAGS); raises when it cannot be
    built or loaded."""
    with _lock:
        if name in _host_libs:
            return _host_libs[name]
        src = CSRC / f"{name}.cc"
        out = _hashed(f"lib{name}", CXX_FLAGS, [src])
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            run = subprocess.run([_cxx(), *CXX_FLAGS, "-o", str(tmp),
                                  str(src)], capture_output=True, text=True)
            if run.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(f"building {src.name} failed:\n"
                                   f"{run.stdout}{run.stderr}")
            os.replace(tmp, out)
        lib = ctypes.CDLL(str(out))
        _host_libs[name] = lib
        return lib


def library() -> ctypes.CDLL:
    """The kernels' shared library, built on first call."""
    global _lib, build_log, build_seconds
    with _lock:
        if _lib is not None:
            return _lib
        srcs = _sources()
        out = _hashed("libtts_kernels", NVCC_FLAGS, srcs)
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            nvcc = _nvcc()
            objs = [tmp.with_name(f"{tmp.name}.{s.stem}.o") for s in srcs]
            t0 = time.perf_counter()
            procs = [subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(s)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                for s, o in zip(srcs, objs)]
            logs = [p.communicate()[0] for p in procs]
            link = None
            if all(p.returncode == 0 for p in procs):
                link = subprocess.run(
                    [nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
                    capture_output=True, text=True)
                logs.append(link.stdout + link.stderr)
            build_seconds = time.perf_counter() - t0
            build_log = "".join(logs)
            for o in objs:
                o.unlink(missing_ok=True)
            if link is None or link.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(f"nvcc failed:\n{build_log}")
            os.replace(tmp, out)
        lib = ctypes.CDLL(str(out))
        p, i = ctypes.c_void_p, ctypes.c_int
        for fn, n_int in (("resblock1_pass_f32", 5),
                          ("resblock1_pass_bf16", 5),
                          ("resblock1_fused_f32", 8),
                          ("resblock1_fused_bf16", 8)):
            getattr(lib, fn).argtypes = [p] * 6 + [i] * n_int + [p]
            getattr(lib, fn).restype = i
        lib.resblock1_tf32_split.argtypes = [p, p, p, i, p]
        lib.resblock1_tf32_split.restype = i
        lib.mas_forward.argtypes = [p] * 5 + [i] * 3 + [p]
        lib.mas_forward.restype = i
        lib.mas_scratch_words.argtypes = [i, i]
        lib.mas_scratch_words.restype = i
        _lib = lib
        return lib
