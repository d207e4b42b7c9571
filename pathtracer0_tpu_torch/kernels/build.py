"""Build the sources under csrc/ and load them with ctypes.

Each library has a plain C interface. The CUDA ones (LIBS) are compiled by
nvcc for Hopper (sm_90a), the host ones (HOST_LIBS: the LBVH build, the
OBJ tokenizer, and for the CPU tests the forest kernels' triangle test,
the block kernel's dense triangle loop, the group-test kernels'
candidate test and group loop, the streamed walk's row cull, the bounce
kernel's per-ray body and the
streamed route's sort key) by
g++, into
`_build/` at first use, and cached there under a hash of their sources
and the flags; `build_all` starts one compiler per library together, so
a fresh checkout pays the slowest build and not their sum.
Nothing here runs at import time.

Numerics: no --use_fast_math, and -fmad=false so that no multiply-add is
contracted; the plain PyTorch versions do not contract either, and a
contracted FMA flips knife-edge comparisons.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PKG = Path(__file__).resolve().parents[1]
CSRC = PKG / "csrc"
BUILD = PKG / "_build"
# library -> its source, then the headers it includes
LIBS = {
    "frame_kernel": ("frame_kernel.cu", "integrate.cuh", "pathtrace.cuh"),
    "block_kernel": ("block_kernel.cu", "integrate.cuh", "pathtrace.cuh"),
    "bounce_kernel": ("bounce_kernel.cu", "integrate.cuh", "pathtrace.cuh"),
    "forest_kernel": ("forest_kernel.cu", "tri_divide.cuh"),
    "streamed_kernel": ("streamed_kernel.cu", "row_cull.cuh", "tri_free.cuh",
                        "sort_key.cuh"),
    "mxu_group_kernel": ("mxu_group_kernel.cu", "tri_free.cuh",
                         "group_test.cuh"),
}
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# built by g++ for the host; no contraction here either, so the LBVH
# build's float32 boxes equal the NumPy build's bit for bit, and the
# forest kernels' triangle test (tri_divide.cuh), the block kernel's
# dense triangle loop (pathtrace.cuh), the group-test kernels' candidate
# test, group loop and row cull (group_test.cuh, tri_free.cuh,
# row_cull.cuh), the bounce
# kernel's per-ray body (integrate.cuh `bounce_ray`) and the sort key
# (sort_key.cuh) equal the plain versions'; the OBJ tokenizer (objparse.cpp) does no float arithmetic
# beyond strtod
HOST_LIBS = {"streambuild": ("streambuild.cpp",),
             "objparse": ("objparse.cpp",),
             "tri_divide": ("tri_divide_host.cpp", "tri_divide.cuh"),
             "dense_hit": ("dense_hit_host.cpp", "pathtrace.cuh"),
             "group_test": ("group_test_host.cpp", "group_test.cuh",
                            "row_cull.cuh", "tri_free.cuh"),
             "bounce": ("bounce_host.cpp", "integrate.cuh", "pathtrace.cuh"),
             "sort_key": ("sort_key_host.cpp", "sort_key.cuh")}
HOST_FLAGS = ["-std=c++17", "-O3", "-ffp-contract=off", "-shared", "-fPIC"]

_libs = {}
ptxas_log = {}  # library -> its compiler's output (nvcc: registers, spills)


def nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def gxx() -> str:
    found = shutil.which("g++")
    if not found:
        raise RuntimeError("g++ not found: the host libraries (the LBVH "
                           "builder csrc/streambuild.cpp, the OBJ tokenizer "
                           "csrc/objparse.cpp) cannot be built")
    return found


def _recipe(name: str):
    """(sources, function that finds the compiler, flags) of `name`."""
    if name in HOST_LIBS:
        return HOST_LIBS[name], gxx, HOST_FLAGS
    return LIBS[name], nvcc, FLAGS


def _target(name: str) -> Path:
    sources, _, flags = _recipe(name)
    h = hashlib.sha256(" ".join(flags).encode())
    for src in sources:
        h.update((CSRC / src).read_bytes())
    return BUILD / f"lib{name}_{h.hexdigest()[:16]}.so"


def build_all(names=(*LIBS, *HOST_LIBS)):
    """Compile every library of `names` that is not built yet, all
    compilers running at once. Raises if one fails."""
    running = []
    for name in names:
        out = _target(name)
        if out.exists():
            continue
        BUILD.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        sources, compiler, flags = _recipe(name)
        proc = subprocess.Popen(
            [compiler(), *flags, "-o", str(tmp), str(CSRC / sources[0])],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        running.append((name, out, tmp, proc))
    failed = []
    for name, out, tmp, proc in running:
        ptxas_log[name] = proc.communicate()[0]
        if proc.returncode:
            failed.append(f"the build of {name} failed:\n{ptxas_log[name]}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))


def load(name: str = "frame_kernel"):
    """The loaded library `name`, built first if needed."""
    if name not in _libs:
        build_all((name,))
        _libs[name] = ctypes.CDLL(str(_target(name)))
    return _libs[name]


def ptr(t, dtype, device) -> int:
    """The device address of tensor `t` for a kernel's argument struct; a
    tensor of another type or device, or one that is not contiguous, is
    refused."""
    if t.device != device or t.dtype != dtype or not t.is_contiguous():
        raise ValueError(
            f"the kernel needs contiguous {dtype} tensors on {device}, "
            f"got {t.dtype} on {t.device}")
    return t.data_ptr()
