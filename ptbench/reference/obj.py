"""Wavefront OBJ text -> flat numpy buffers, as the Rust reference's ``tobj`` loads it
with ``OFFLINE_RENDERING_LOAD_OPTIONS``: one indexed mesh, faces of more than 3 vertices
fan-triangulated, v/vt/vn triples re-indexed into one vertex stream.
"""

from __future__ import annotations

import numpy as np


def load_obj(path: str):
    """Parse an OBJ file.

    Returns dict with:
      positions: [V,3] float32
      normals:   [V,3] float32 or None (aligned with positions)
      uvs:       [V,2] float32 or None
      indices:   [F,3] int32
    """
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
