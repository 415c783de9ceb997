"""Builds the port's native libraries from ``csrc/`` at first use.

Each source ``csrc/<name>.cu`` (a CUDA kernel, built with nvcc) or
``csrc/<name>.cpp`` (host code, built with g++) becomes a shared library with a
plain C interface, loaded with ctypes. Libraries go into ``tpupt_torch/_build/``
(git-ignored), named by a hash of the source and the flags, so an edited source
is rebuilt and an unchanged one is loaded as it is. ``build_all`` starts one
compiler per source, all at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

from . import trace

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17",
    "--fmad=false",  # each multiply and add rounds on its own, like the eager plain versions
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]
GXX_FLAGS = ["-O2", "-shared", "-fPIC", "-std=c++17"]

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build the port's kernels")


def _gxx() -> str:
    cand = shutil.which("g++")
    if not cand:
        raise RuntimeError("g++ not found: a C++ compiler is needed to build the host library")
    return cand


def _source(name: str) -> tuple[str, list[str], str]:
    """(source path, flags, compiler kind) of `name`: csrc/<name>.cu or csrc/<name>.cpp."""
    cu = os.path.join(CSRC, f"{name}.cu")
    if os.path.exists(cu):
        return cu, NVCC_FLAGS, "nvcc"
    return os.path.join(CSRC, f"{name}.cpp"), GXX_FLAGS, "g++"


def _lib_path(name: str) -> str:
    src, flags, _ = _source(name)
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(flags).encode()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"lib{name}_{digest}.so")


def _start(name: str):
    """Start the compiler for `name` unless its library is built -> (path, job or None)."""
    path = _lib_path(name)
    if os.path.exists(path):
        return path, None
    os.makedirs(BUILD_DIR, exist_ok=True)
    src, flags, kind = _source(name)
    tmp = f"{path}.{os.getpid()}.tmp"
    cc = _nvcc() if kind == "nvcc" else _gxx()
    cmd = [cc, *flags, "-o", tmp, src]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return path, (proc, tmp)


def _finish(name: str, path: str, job) -> str:
    """Wait for a started build; returns the compiler's report ('' if nothing was built)."""
    if job is None:
        return ""
    proc, tmp = job
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"build failed for {os.path.relpath(_source(name)[0], _HERE)}:\n{out}")
    os.replace(tmp, path)  # atomic: a concurrent loader never sees half a file
    return out


def build_all(names) -> dict[str, str]:
    """Build every named library in parallel -> {name: compiler report}."""
    jobs = {name: _start(name) for name in names}
    return {name: _finish(name, *jobs[name]) for name in names}


def load(name: str) -> ctypes.CDLL:
    """The ctypes library `name`, built first if needed. Its first load in a process is the
    span ``build.load`` (attrs: lib, and built: the compiler that ran, or "cached")."""
    if name not in _loaded:
        with trace.span("build.load", lib=name) as sp:
            path, job = _start(name)
            _finish(name, path, job)
            _loaded[name] = ctypes.CDLL(path)
            if sp is not None:
                sp.attrs["built"] = "cached" if job is None else _source(name)[2]
    return _loaded[name]
