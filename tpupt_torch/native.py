"""The host library (``csrc/native_host.cpp``: OBJ parse, Morton and binned-SAH builds), loaded via ctypes.

Counterpart of ``tpupt/native``. The library is built with g++ at first use into
``tpupt_torch/_build/`` (build.py). Every entry point returns None when the
library cannot be built or loaded; the callers (io/obj.py, ops/bvh.py) then run
their numpy versions, which give identical output. ``builder()`` says which one
ran.
"""

from __future__ import annotations

import ctypes

import numpy as np

_lib = None
_load_error: str | None = None

_P = ctypes.c_void_p


def _load():
    global _lib, _load_error
    if _lib is not None or _load_error is not None:
        return _lib
    try:
        from . import build

        lib = build.load("native_host")
        lib.obj_parse.restype = _P
        lib.obj_parse.argtypes = [ctypes.c_char_p]
        for fn in (lib.obj_num_vertices, lib.obj_num_faces):
            fn.restype = ctypes.c_int64
            fn.argtypes = [_P]
        for fn in (lib.obj_has_normals, lib.obj_has_uvs):
            fn.restype = ctypes.c_int
            fn.argtypes = [_P]
        lib.obj_copy.argtypes = [_P] * 5
        lib.obj_free.argtypes = [_P]
        lib.bvh_build.restype = _P
        lib.bvh_build.argtypes = [_P, _P, _P, ctypes.c_int64]
        lib.bvh_num_nodes.restype = ctypes.c_int64
        lib.bvh_num_nodes.argtypes = [_P]
        lib.bvh_copy.argtypes = [_P] * 7
        lib.bvh_free.argtypes = [_P]
        lib.bvh_build_sah.restype = _P
        lib.bvh_build_sah.argtypes = [_P, _P, _P, ctypes.c_int64]
        for fn in (lib.bvh_num_nodes_sah, lib.bvh_num_clusters):
            fn.restype = ctypes.c_int64
            fn.argtypes = [_P]
        lib.bvh_copy_sah.argtypes = [_P] * 11
        lib.bvh_free_sah.argtypes = [_P]
        _lib = lib
    except Exception as e:  # no compiler / build failure -> the numpy builders
        _load_error = f"{type(e).__name__}: {e}"
    return _lib


def available() -> bool:
    return _load() is not None


def builder() -> str:
    """'native' when the host library loaded, else 'numpy (<why>)'."""
    return "native" if available() else f"numpy ({_load_error})"


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(_P)


def parse_obj(path: str):
    """Native OBJ parse -> the dict of io.obj.load_obj, or None."""
    lib = _load()
    if lib is None:
        return None
    h = lib.obj_parse(path.encode())
    if not h:
        return None
    try:
        nv, nf = lib.obj_num_vertices(h), lib.obj_num_faces(h)
        pos = np.empty((nv, 3), np.float32)
        nrm = np.empty((nv, 3), np.float32)
        uv = np.empty((nv, 2), np.float32)
        idx = np.empty((nf, 3), np.int32)
        lib.obj_copy(h, _ptr(pos), _ptr(nrm), _ptr(uv), _ptr(idx))
        return {
            "positions": pos,
            "normals": nrm if lib.obj_has_normals(h) else None,
            "uvs": uv if lib.obj_has_uvs(h) else None,
            "indices": idx,
        }
    finally:
        lib.obj_free(h)


def build_tri_bvh_sah(v0: np.ndarray, e1: np.ndarray, e2: np.ndarray):
    """Native binned-SAH build -> (order, nodes, clusters) of ops.bvh.build_tri_bvh_sah, or None."""
    lib = _load()
    if lib is None:
        return None
    v0, e1, e2 = (np.ascontiguousarray(a, np.float32) for a in (v0, e1, e2))
    n = v0.shape[0]
    h = lib.bvh_build_sah(_ptr(v0), _ptr(e1), _ptr(e2), n)
    if not h:
        return None
    try:
        m, c = lib.bvh_num_nodes_sah(h), lib.bvh_num_clusters(h)
        order = np.empty(n, np.int32)
        nodes = dict(
            bmin=np.empty((m, 3), np.float32),
            bmax=np.empty((m, 3), np.float32),
            skip=np.empty(m, np.int32),
            start=np.empty(m, np.int32),
            count=np.empty(m, np.int32),
        )
        clusters = dict(
            start=np.empty(c, np.int32),
            count=np.empty(c, np.int32),
            bmin=np.empty((c, 3), np.float32),
            bmax=np.empty((c, 3), np.float32),
        )
        lib.bvh_copy_sah(
            h, _ptr(order),
            *(_ptr(nodes[k]) for k in ("bmin", "bmax", "skip", "start", "count")),
            *(_ptr(clusters[k]) for k in ("start", "count", "bmin", "bmax")),
        )
        return order, nodes, clusters
    finally:
        lib.bvh_free_sah(h)


def build_tri_bvh(v0: np.ndarray, e1: np.ndarray, e2: np.ndarray):
    """Native Morton build -> (order, nodes) of ops.bvh.build_tri_bvh, or None."""
    lib = _load()
    if lib is None:
        return None
    v0, e1, e2 = (np.ascontiguousarray(a, np.float32) for a in (v0, e1, e2))
    n = v0.shape[0]
    h = lib.bvh_build(_ptr(v0), _ptr(e1), _ptr(e2), n)
    if not h:
        return None
    try:
        m = lib.bvh_num_nodes(h)
        order = np.empty(n, np.int32)
        nodes = dict(
            bmin=np.empty((m, 3), np.float32),
            bmax=np.empty((m, 3), np.float32),
            skip=np.empty(m, np.int32),
            start=np.empty(m, np.int32),
            count=np.empty(m, np.int32),
        )
        lib.bvh_copy(h, _ptr(order), *(_ptr(nodes[k]) for k in ("bmin", "bmax", "skip", "start", "count")))
        return order, nodes
    finally:
        lib.bvh_free(h)
