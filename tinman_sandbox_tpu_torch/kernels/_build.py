"""Build and load the package's CUDA kernels.

Each source under ``csrc/`` is compiled by ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface, loaded with ctypes; tensors go
in as ``data_ptr()`` integers and the stream as PyTorch's current stream.
The sources include no PyTorch header, so a build takes seconds, and all
sources compile in parallel (one ``nvcc`` each). Libraries land in
``build/torch_kernels/`` at the repository root, named by a hash of their
source, of every shared header ``csrc/*.cuh`` and of the flags, so an
unchanged source is not rebuilt and an edited header rebuilds every source.

Nothing here runs at import time: the first launch builds.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess

__all__ = ["BUILD_DIR", "SOURCES", "SOURCE_FLAGS", "build_kernels",
           "library", "ptxas_log"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "torch_kernels")
SOURCES = {"caar": "caar.cu", "dss": "dss.cu", "hypervis": "hypervis.cu",
           "probe": "probe.cu", "remap": "remap.cu", "saxpby": "saxpby.cu",
           "tracer": "tracer.cu"}
_FLAGS = ["-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]
# flags of one source on top of _FLAGS: caar.cu is built without FMA
# contraction, so every FMA in it is an explicit fmaf and the bits of a
# column do not depend on which kernel inlines the chunked body (the
# chunked kernel with or without its stash, the ring kernel); remap.cu so
# that its dp rows round every product and sum on its own, as the plain
# PyTorch code does; tracer.cu so that the Euler kernel and the ring kernel,
# which inline the same per-row body, write the same bits
SOURCE_FLAGS = {"caar": ["-fmad=false"], "remap": ["-fmad=false"],
                "tracer": ["-fmad=false"]}


def _flags(name: str) -> list:
    return _FLAGS + SOURCE_FLAGS.get(name, [])


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    if not os.path.exists(cand):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return cand


def _lib_path(name: str, csrc: str = _CSRC) -> str:
    """The library path of source ``name``: a hash of the source, of every
    header ``*.cuh`` in ``csrc`` (by name, in sorted order) and of the
    flags."""
    digest = hashlib.sha256(" ".join(_flags(name)).encode())
    headers = sorted(f for f in os.listdir(csrc) if f.endswith(".cuh"))
    for fname in [SOURCES[name], *headers]:
        with open(os.path.join(csrc, fname), "rb") as f:
            digest.update(fname.encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"lib{name}_{digest.hexdigest()[:12]}.so")


def ptxas_log(name: str) -> str:
    """Path of nvcc's register / shared-memory report for the library of
    ``name``, written beside it by the build that made it."""
    return _lib_path(name)[:-len(".so")] + ".ptxas.log"


def build_kernels(names=None) -> dict:
    """Compile the named sources (default: all) that are not built yet, all
    at once. Returns {name: library path}; raises with nvcc's output if any
    compile fails."""
    names = list(SOURCES) if names is None else list(names)
    os.makedirs(BUILD_DIR, exist_ok=True)
    paths = {n: _lib_path(n) for n in names}
    todo = {n: p for n, p in paths.items() if not os.path.exists(p)}
    if not todo:
        return paths
    nvcc = _nvcc()
    procs = {}
    for n, p in todo.items():
        tmp = f"{p}.{os.getpid()}.tmp"
        procs[n] = (tmp, subprocess.Popen(
            [nvcc, *_flags(n), "-o", tmp, os.path.join(_CSRC, SOURCES[n])],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs, failed = [], []
    for n, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        logs.append(f"== {SOURCES[n]} (rc {proc.returncode})\n{out}")
        if proc.returncode == 0:
            with open(ptxas_log(n), "w") as f:
                f.write(out)
            os.replace(tmp, todo[n])
        else:
            failed.append(n)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs))
    return paths


_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "caar": {
        "caar_launch": [_P] * 26 + [_I] * 12 + [_F] * 4 + [_P, _I],
        "caar_ring_launch": [_P] * 24 + [_I] * 13 + [_F] * 6
        + [_P, _I],
        "caar_blocks_per_sm": [_I] * 6,
        "caar_error_string": [_I],
    },
    "dss": {
        "dss_sweep_launch": [_P, _P, _I, _P, _I, _P, _P, _I, _F, _F, _P, _I,
                             _I, _I, _P, _I],
        "dss_sweep_blocks_per_sm": [_I, _I, _I],
        "dss_sweep_banded_launch": [_P, _P, _I, _P, _I, _P, _P, _P, _F, _F,
                                    _P, _I, _I, _I, _I, _I, _P, _I],
        "dss_patch_launch": [_P, _P, _P, _P, _I, _P, _F, _F, _I, _I, _P, _I],
        "dss_fixup_launch": [_P, _P, _P, _P, _I, _I, _P, _I, _I, _P, _I],
        "dss_extract_launch": [_P, _P, _P, _I, _I, _I, _P, _I],
        "dss_error_string": [_I],
    },
    "hypervis": {
        "hypervis_vlap_launch": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _F,
                                 _P, _I],
        "hypervis_error_string": [_I],
    },
    "probe": {
        "probe_mm_launch": [_P, _P, _P] + [_I] * 9 + [_P, _I],
        "probe_occupancy": [_I] * 9 + [ctypes.POINTER(_I)] * 2,
        "probe_error_string": [_I],
    },
    "remap": {
        "remap_packed_launch": [_I, _I, _P, _P, _P, _P, ctypes.c_double, _P,
                                _P, _I, _I, _I, _P, _I],
        "remap_levels_launch": [_I, _I, _P, _P, _P, _P, _I, _I, _I, _P, _I],
        "remap_smem_bytes": [_I, _I, _I],
        "remap_blocks_per_sm": [_I] * 5,
        "remap_error_string": [_I],
    },
    "saxpby": {
        "saxpby_f32_launch": [_F, _F, _P, _P, ctypes.c_longlong, _P, _I],
        "saxpby_f64_launch": [ctypes.c_double, ctypes.c_double, _P, _P,
                              ctypes.c_longlong, _P, _I],
        "saxpby_error_string": [_I],
    },
    "tracer": {
        "tracer_euler_launch": [_P] * 8 + [_I] * 8 + [_F, _F, _P, _I],
        "tracer_limit_launch": [_P] * 9 + [_I] * 8 + [_F] * 4 + [_P, _I],
        "tracer_row_launch": [_P] * 6 + [_I] * 3 + [_F] * 2 + [_P, _I],
        "tracer_ring_launch": [_P] * 12 + [_I] * 12 + [_F] * 4 + [_P, _I],
        "tracer_blocks_per_sm": [_I, _I],
        "tracer_error_string": [_I],
    },
}


@functools.lru_cache(maxsize=None)
def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``name``, built first if needed."""
    lib = ctypes.CDLL(build_kernels([name])[name])
    for fn, argtypes in _SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_char_p if fn.endswith("_error_string") else _I
    return lib


def check_launch(name: str, err: int) -> None:
    """Raise if a launch returned a CUDA error."""
    if err != 0:
        msg = getattr(library(name), f"{name}_error_string")(err)
        raise RuntimeError(f"{name} kernel launch failed: "
                           f"{msg.decode() if msg else err}")
