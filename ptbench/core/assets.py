"""Stand-in asset files that a configuration names under "stand_ins".

The writers are frozen copies of the port's smoke script's: a lumpy UV sphere of
2*nu*nv triangles with vertex normals (and UVs) as OBJ text, and a synthetic latlong
sky (a gradient and a sun) as a Radiance file. The same parameters write the same
bytes, so the program and the reference read the same files.
"""

from __future__ import annotations

import os

import numpy as np


def _write_blob_obj(path, nu, nv, center, radius, seed, uvs):
    """A lumpy UV sphere of 2*nu*nv triangles with vertex normals (and UVs) as OBJ text."""
    rng = np.random.default_rng(seed)
    k = rng.integers(2, 6, size=4)
    th, ph = np.meshgrid(np.linspace(0, np.pi, nv + 1), np.linspace(0, 2 * np.pi, nu + 1), indexing="ij")
    r = radius * (1.0 + 0.15 * np.sin(k[0] * th) * np.cos(k[1] * ph) + 0.08 * np.cos(k[2] * th + k[3] * ph))
    n = np.stack([np.sin(th) * np.cos(ph), np.cos(th), np.sin(th) * np.sin(ph)], -1).reshape(-1, 3)
    pos = np.asarray(center) + r.reshape(-1, 1) * n
    i = np.arange(nv)[:, None] * (nu + 1) + np.arange(nu)[None, :] + 1  # OBJ indices are 1-based
    faces = np.stack([i, i + nu + 1, i + 1, i + 1, i + nu + 1, i + nu + 2], -1).reshape(-1, 3)
    lines = [f"v {x:.6f} {y:.6f} {z:.6f}" for x, y, z in pos]
    lines += [f"vn {x:.6f} {y:.6f} {z:.6f}" for x, y, z in n]
    if uvs:
        lines += [f"vt {u:.6f} {v:.6f}" for u, v in zip(ph.ravel() / (2 * np.pi), 1 - th.ravel() / np.pi)]
        lines += ["f " + " ".join(f"{a}/{a}/{a}" for a in f) for f in faces]
    else:
        lines += ["f " + " ".join(f"{a}//{a}" for a in f) for f in faces]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return len(faces)


def _write_hdr(path, w=128, h=64):
    """A synthetic latlong sky (gradient + sun) as a Radiance file, RLE and flat rows mixed."""
    v, u = np.meshgrid((np.arange(h) + 0.5) / h, (np.arange(w) + 0.5) / w, indexing="ij")
    sky = np.stack([0.4 + 0.5 * (1 - v), 0.5 + 0.4 * (1 - v), 0.9 + 0.1 * (1 - v)], -1)
    sun = 30.0 * np.exp(-((u - 0.3) ** 2 + (v - 0.25) ** 2) / 0.002)
    img = (sky * (v < 0.5)[..., None] + 0.3 * (v >= 0.5)[..., None] + sun[..., None]).astype(np.float32)
    m = img.max(-1)
    f, e = np.frexp(m)
    scale = np.where(m > 1e-32, f * 256.0 / np.maximum(m, 1e-32), 0.0)
    rgbe = np.zeros((h, w, 4), np.uint8)
    rgbe[..., :3] = np.clip(img * scale[..., None], 0, 255).astype(np.uint8)
    rgbe[..., 3] = np.where(m > 1e-32, e + 128, 0).astype(np.uint8)
    out = bytearray(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n" + f"-Y {h} +X {w}\n".encode())
    for y in range(h):
        if y % 2:
            out += rgbe[y].tobytes()
            continue
        out += bytes([2, 2, w >> 8, w & 255])
        for c in range(4):
            plane, x = rgbe[y, :, c], 0
            while x < w:
                run = 1
                while x + run < w and run < 127 and plane[x + run] == plane[x]:
                    run += 1
                if run >= 3:
                    out += bytes([128 + run, plane[x]])
                    x += run
                else:
                    n = min(w - x, 16)
                    out += bytes([n]) + plane[x : x + n].tobytes()
                    x += n
    with open(path, "wb") as f:
        f.write(bytes(out))


def write_stand_ins(cfg: dict, root: str) -> dict:
    """Write the configuration's stand-in files into `root` -> {file: triangles or None}."""
    os.makedirs(root, exist_ok=True)
    out = {}
    for name, spec in cfg.get("stand_ins", {}).items():
        path = os.path.join(root, name)
        if spec["writer"] == "blob_obj":
            out[name] = _write_blob_obj(path, spec["nu"], spec["nv"], tuple(spec["center"]), spec["radius"],
                                        spec["seed"], spec["uvs"])
        elif spec["writer"] == "hdr":
            _write_hdr(path, spec["width"], spec["height"])
            out[name] = None
        else:
            raise ValueError(f"unknown stand-in writer {spec['writer']!r}")
    return out
