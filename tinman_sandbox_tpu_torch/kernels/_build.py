"""Build and load the package's CUDA kernels.

Each source under ``csrc/`` is compiled by ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface, loaded with ctypes; tensors go
in as ``data_ptr()`` integers and the stream as PyTorch's current stream.
The sources include no PyTorch header, so a build takes seconds, and all
sources compile in parallel (one ``nvcc`` each). Libraries land in
``build/torch_kernels/`` at the repository root, named by a hash of their
source and flags, so an unchanged source is not rebuilt.

Nothing here runs at import time: the first launch builds.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess

__all__ = ["BUILD_DIR", "SOURCES", "build_kernels", "library", "ptxas_log"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "torch_kernels")
SOURCES = {"caar": "caar.cu", "saxpby": "saxpby.cu"}
_FLAGS = ["-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]


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


def _lib_path(name: str) -> str:
    with open(os.path.join(_CSRC, SOURCES[name]), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(_FLAGS).encode())
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
            [nvcc, *_FLAGS, "-o", tmp, os.path.join(_CSRC, SOURCES[n])],
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
        "caar_launch": [_P] * 21 + [_I] * 4 + [_F] * 4 + [_P, _I],
        "caar_error_string": [_I],
    },
    "saxpby": {
        "saxpby_f32_launch": [_F, _F, _P, _P, ctypes.c_longlong, _P, _I],
        "saxpby_f64_launch": [ctypes.c_double, ctypes.c_double, _P, _P,
                              ctypes.c_longlong, _P, _I],
        "saxpby_error_string": [_I],
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
