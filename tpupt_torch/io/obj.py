"""Wavefront OBJ loader -> flat numpy buffers (counterpart of ``tpupt/io/obj.py``).

Replaces the reference's `tobj` crate (mesh.rs:149-197, main.rs:408). Like
``tobj::OFFLINE_RENDERING_LOAD_OPTIONS`` the result is a single indexed mesh:
positions, optional per-vertex normals and texcoords, and a triangle index buffer.
Faces with more than 3 vertices are fan-triangulated; v/vt/vn index triples are
re-indexed into one unified vertex stream (what tobj's ``single_index`` does).
"""

from __future__ import annotations

import numpy as np

from .. import trace


def load_obj(path: str, native: bool = True):
    """Parse an OBJ file.

    Returns dict with:
      positions: [V,3] float32
      normals:   [V,3] float32 or None (aligned with positions)
      uvs:       [V,2] float32 or None
      indices:   [F,3] int32

    Prefers the host library (tpupt_torch/native.py); this Python parser is the
    fallback and the oracle for tests. A missing file raises FileNotFoundError
    (the native parser returns None for it and the fallback's open raises). The span
    ``scene.obj``.
    """
    with trace.span("scene.obj"):
        return _load_obj(path, native)


def _load_obj(path, native):
    if native:
        from .. import native as _native

        mesh = _native.parse_obj(path)
        if mesh is not None:
            return mesh
    positions, normals, uvs = [], [], []
    remap: dict = {}  # (vi, ti, ni) -> unified index
    out_pos, out_nrm, out_uv, faces = [], [], [], []
    any_n = False
    any_t = False

    def resolve(idx: int, n: int) -> int:
        # OBJ indices are 1-based; negative ones count from the end
        return idx - 1 if idx > 0 else n + idx

    with open(path, "r") as f:
        for line in f:
            if line.startswith("v "):
                parts = line.split()
                positions.append([float(parts[1]), float(parts[2]), float(parts[3])])
            elif line.startswith("vn "):
                parts = line.split()
                normals.append([float(parts[1]), float(parts[2]), float(parts[3])])
            elif line.startswith("vt "):
                parts = line.split()
                uvs.append([float(parts[1]), float(parts[2])])
            elif line.startswith("f "):
                verts = []
                for tok in line.split()[1:]:
                    comps = tok.split("/")
                    vi = resolve(int(comps[0]), len(positions))
                    ti = resolve(int(comps[1]), len(uvs)) if len(comps) > 1 and comps[1] else -1
                    ni = resolve(int(comps[2]), len(normals)) if len(comps) > 2 and comps[2] else -1
                    key = (vi, ti, ni)
                    if key not in remap:
                        remap[key] = len(out_pos)
                        out_pos.append(positions[vi])
                        out_uv.append(uvs[ti] if ti >= 0 else [0.0, 0.0])
                        out_nrm.append(normals[ni] if ni >= 0 else [0.0, 0.0, 0.0])
                    verts.append(remap[key])
                    any_t |= ti >= 0
                    any_n |= ni >= 0
                for k in range(1, len(verts) - 1):  # fan triangulation
                    faces.append([verts[0], verts[k], verts[k + 1]])

    return {
        "positions": np.asarray(out_pos, dtype=np.float32),
        "normals": np.asarray(out_nrm, dtype=np.float32) if any_n else None,
        "uvs": np.asarray(out_uv, dtype=np.float32) if any_t else None,
        "indices": np.asarray(faces, dtype=np.int32),
    }


def subdivide_mesh(mesh: dict, levels: int = 1) -> dict:
    """Midpoint 1->4 triangle subdivision (linear, no smoothing).

    Edge midpoints are shared between adjacent triangles; normals are averaged
    and renormalized, UVs averaged. Used to build meshes large enough for the
    two-level cluster kernel (ops/tri_kernel.py) from the shipped assets.
    """
    for _ in range(levels):
        pos, nrm, uv, idx = mesh["positions"], mesh["normals"], mesh["uvs"], mesh["indices"]
        pos_l = list(pos)
        nrm_l = None if nrm is None else list(nrm)
        uv_l = None if uv is None else list(uv)
        mid = {}

        def midpoint(a, b):
            key = (a, b) if a < b else (b, a)
            m = mid.get(key)
            if m is None:
                m = len(pos_l)
                pos_l.append((pos[a] + pos[b]) * 0.5)
                if nrm_l is not None:
                    n = nrm[a] + nrm[b]
                    ln = float(np.linalg.norm(n))
                    nrm_l.append(n / ln if ln > 1e-12 else nrm[a])
                if uv_l is not None:
                    uv_l.append((uv[a] + uv[b]) * 0.5)
                mid[key] = m
            return m

        faces = np.empty((len(idx) * 4, 3), dtype=np.int32)
        for f, (i0, i1, i2) in enumerate(np.asarray(idx)):
            a, b, c = midpoint(i0, i1), midpoint(i1, i2), midpoint(i2, i0)
            faces[4 * f : 4 * f + 4] = [[i0, a, c], [a, i1, b], [c, b, i2], [a, b, c]]
        mesh = {
            "positions": np.asarray(pos_l, dtype=np.float32),
            "normals": None if nrm_l is None else np.asarray(nrm_l, dtype=np.float32),
            "uvs": None if uv_l is None else np.asarray(uv_l, dtype=np.float32),
            "indices": faces,
        }
    return mesh
