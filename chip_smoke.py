"""Smoke test of the PyTorch/CUDA port on one GPU: builds the kernels, holds each
against its plain PyTorch version, drives the main path through four scenes and
prints the numbers PERF.md quotes.

    python3 chip_smoke.py                 # default: one card
    python3 chip_smoke.py --profile DIR   # add a torch.profiler pass (renders, grads), tables in DIR

The main path is the forward render (render_image) of:
- the Cornell box, 600x600, max_depth 50: spheres and quads through K1;
- scene 6 (everything_scene), 600 px wide, max_depth 50: 16.6k triangles through
  the flat cluster kernel (K2), spheres and quads through K1;
- "bigmesh", a 318k-triangle mesh (a 4968-triangle mesh subdivided 3 times),
  600x600, max_depth 50: the two-level cluster kernel (K3);
- the balls scene (scene 1), 600x337, max_depth 50: 486 spheres through K1 alone;
- the environment-map scene (scene 4) with its HDR sky kept in f32 and importance
  sampled, 600x337, max_depth 50: K1;
- scenes 2 (earth), 5 (BSDF demo) and 7 (normal maps), 600 px wide, max_depth 50, at
  4 spp: K1, with their JPEG and PNG textures decoded by the port's own readers
  (the committed stand-ins of tests/torch_data/, each first held bit for bit against
  its .npy, PIL's decode of it), each rendered twice: from the baseline stand-ins and
  from their twins (progressive earthmap.jpg and envmap.jpg, a 16-bit color.png, an
  Adam7 normal.png), which decode to the same .npy, so the two films must be bit-equal
  and the rays equal; a 1024x512 progressive stand-in is decoded against the sha256
  of PIL's decode and timed;
- the scene-6 stand-in (32 spp) and bigmesh (25 spp) compiled with bvh=True: their meshes
  through the stackless BVH walk (K4), once an iteration;
Each of these renders runs as the port runs a CUDA launch: CUDA graphs whose wavefront
loops run on the card (render/graph.py; conditional WHILE nodes, the stage condition
kernel K5 of csrc/loop_cond.cu), and then again by the eager loop, the graphs' plain
version: the two films must be bit-equal, with equal rays and iterations (the stand-in
renders of scenes 2, 5 and 7; their twins are held to those). Both routes' wall time,
paths/s, iterations, ms an iteration, peak memory and the graphs' capture time go into a
"routes" JSON line; --profile adds each route's device busy share (a "profiles" line).
And the gradient path (render_film_grads: the detached estimator, each trip's carry
saved and the trip replayed in the backward pass) of the Cornell box at bench.py's
`grads` configuration (128x128, 32 spp, 4 lanes a pixel) and at 600x600 (4 spp),
K1 launching in every forward trip and again in its replay. On the card the pass runs
as CUDA graphs (render/graph.py GradGraphs: the forward trips and the replays each a
conditional WHILE node, the segment gate and the countdown K5's gradient modes, one host
read a chunk of trips and one more), first capturing, then replaying with the graphs
kept on the compiled scene; and again by the eager route (plain_grads), its plain
version: films bit-equal, gradients within relative L1 1e-6, trips, forward and backward
ms a trip, capture s, host reads, chunks and peak memory of both routes printed; with
--profile, each route's busy share (the eager route's device time over each route's
wall). The card's gradients are held against the CPU's, and the graphs against the eager
route, on a small box scene, an HDR-map scene (principled, metal), a small mesh (K2, and
K4 with bvh=True) and 60000 random triangles (K3).
Then the sharded phases (parallel/, one process a device): render_image(mesh=...) of
the Cornell box in a world of 1 over NCCL, bit-equal to the render without a mesh;
two gloo ranks spawned on the one card (NCCL puts no two ranks of a communicator on
one GPU): Cornell 600x600 at 32 spp and the scene-6 stand-in 600 px at 8 spp against
one rank, render_grads_sharded of a box against render_grads, and a (1 host x 2
chips) pod mesh against the flat mesh of 2; tpupt_torch.entry.dryrun_multichip over
every visible card (NCCL, a rank a card; its renders and gradients launch K1) and
tpupt_torch.entry.entry() on the card.
Each kernel is held bit-equal to its plain version on random and camera rays and on
the bounce rays that follow its camera rays' hits (K4 also on its camera rays with
every other lane dead and NaN rays), and is timed on both batches: K1 at its three
table shapes (Cornell, scene 6, balls; and again counting its tile cull, whose counts are
held equal to the plain version's), K2 and K3 at theirs, K4 on both mesh shapes
beside K2 and K3 on the same rays (the flags flipped on one SceneData), with the counts
of its own walk (wide-node fetches, triangle tests, steps, the deepest stack). The
matmul sweep (the reference's MXU path) is held against the dense sweep and timed.
The wavefront iteration's two kernels (KW1 regeneration, KW2 shading) are held against
_stream_step, their plain version, on the Cornell box's stage runner at 360,000 lanes
(100 samples a lane): one iteration of each route from the same state, at stage 0 and at
the last stage (11,250 lanes), every field bit for bit; each kernel, the fused iteration
and the plain one are timed there as CUDA graphs, and every render counts their launches.
The film's two kernels (csrc/film.cu: the add of a launch's film into the float64 film
and the resolve into the mean and the image) are held bit for bit, a NaN's payload aside,
against their plain versions on the same inputs copied to the CPU, at the Cornell and balls
frames (360,000 and 202,200 pixels): one launch of the whole frame and then padded pixel
blocks, their films with NaN, +-inf, -0.0 and negative values, and the tonemap's edges;
both are timed there against their bytes, and every render counts one add a launch and
one resolve.
The repository ships no asset files, so the script writes stand-ins for scene 6's
meshes (bunny.obj, spot.obj, cow.obj: lumpy spheres of the real meshes' triangle
counts) and its environment map (grace_probe_latlong.hdr: a synthetic sky) to a
temporary directory, points TPUPT_ASSETS at it, and builds the scenes through the
port's own everything_scene, OBJ parser and .hdr reader. The environment-map scene
gets its own stand-in sky of 1024x512 texels (the alias table has as many rows),
with a small hot sun, in a directory of its own.

Exits non-zero, printing no result, without a CUDA device or outside a checkout
of the repository. The last line of standard output is
{"ok": true, "device": {"platform": "gpu", "kind": <card>, "count": <cards>}}.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import shutil
import socket
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12

# K1's float operations per ray and table slot, and per ray and box of a tile of spheres,
# counted from csrc/hit_kernel.cu (adds, multiplies, one divide or sqrt; compares, minima
# and maxima not counted)
K1_FLOPS_SPHERE = 28
K1_FLOPS_QUAD = 49
K1_FLOPS_BOX = 25
K1_RAY_BYTES = 7 * 4 + 3 * 4  # o, d, time in; t, kind, idx out
# K2/K3's float operations per box test and per triangle test, counted from
# csrc/tri_kernel.cu the same way
TRI_FLOPS_BOX = 24
TRI_FLOPS_TRI = 46
TRI_RAY_BYTES = 7 * 4 + 8 * 4  # o, d, t_in in; t, id, ns xyz, u, v, mat out
# K4's node visit is K2/K3's box test and its leaf test their triangle test, at the same
# counts; its rays move K2/K3's bytes (TRI_RAY_BYTES)
BVH_NODE_BYTES = 8 * 4  # a binary node: its box, skip, start * 8 + count
BVH_TRI_BYTES = 9 * 4  # v0, e1, e2 of a triangle row
BVH_ATTR_BYTES = 16 * 4  # the attribute row of a ray's winner
# the wavefront kernels' bytes (csrc/wavefront.cu): regeneration reads alive, sample, sample0
# of every lane and pix, row, col of a regenerated one, which it writes o, d, time,
# throughput, radiance, bounce, cur_sample, sample, alive; shading reads and writes alive,
# bounce, throughput, radiance, film of every lane, reads o, d, time, pix, cur_sample and K1's
# t, kind, idx of a live one and writes its o, d
KW1_LANE_BYTES, KW1_NEW_BYTES = 1 + 4 + 4, 3 * 4 + 65
KW2_LANE_BYTES, KW2_LIVE_BYTES = 2 * 41, 48 + 24
WAVEFRONT = dict(width=600, spp=100, iterations=6)  # Cornell's runner; iterations into a stage
# the film's kernels (csrc/film.cu) at the frame cells' shapes (width, height, spp): one launch
# of the whole frame, then launches of FILM_BLOCK-pixel blocks over it, the last padded. add
# reads a lane's film (12 B) and id (4 B) and reads and writes its pixel's float64 film (48 B);
# resolve reads the film (24 B) and writes the mean (12 B) and the image (3 B) of a pixel
FILM_SHAPES = {"cornell": (600, 600, 100), "balls": (600, 337, 100)}
FILM_BLOCK = 65536
FILM_ADD_BYTES, FILM_RESOLVE_BYTES = 12 + 4 + 48, 24 + 12 + 3
MXU_VALID_SHARE = 0.999  # the matmul sweep against the dense sweep (tests/test_bvh.py:129-135)
MXU_TOL = 1e-4

# bigmesh: bench.py's min(BENCH_SPP, 25); balls: a short render for K1's launch count there;
# env: the HDR environment-map scene (bench.py's lights_hdr at min(spp, 100)), cut for time
SPP = {"cornell": 32, "scene6": 32, "bigmesh": 25, "balls": 8, "env": 8, "textures": 4}
SHARDED_SPP = {"cornell": 32, "scene6": 8}  # the two-rank phase: the Cornell box and the scene-6 stand-in
SHARDED_JOIN_S = 420  # a spawned rank's own timeout
FIXTURES = ("earthmap.jpg", "envmap.jpg", "bricks/color.png", "bricks/normal.png")
FIXTURE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "torch_data")
# twins of the stand-ins in the encodings PIL reads beside baseline JPEG and plain PNG, each
# decoding to the .npy of its stand-in (tools/make_torch_image_fixtures.py); the scenes'
# twin renders read the first twin of each stand-in under the stand-in's name
TWINS = {
    "earthmap_progressive.jpg": "earthmap.jpg", "envmap_progressive.jpg": "envmap.jpg",
    "bricks/color16.png": "bricks/color.png", "bricks/normal_adam7.png": "bricks/normal.png",
    "earthmap_progressive_rst.jpg": "earthmap.jpg",
}
BIG_PROGRESSIVE = "earthmap_1024_progressive.jpg"  # 1024x512 4:2:0; the sha256 of PIL's decode beside it
HDR_ENV_WH = (1024, 512)  # the environment-map scene's stand-in sky
# gradients: bench.py's `grads` configuration, and the full width at fewer samples
GRADS = {"grads": dict(width=128, spp=32, replicas=4), "grads 600": dict(width=600, spp=4, replicas=None)}
GRAD_REL_L1 = 2e-2  # card against CPU gradients, per field (tests/test_torch_cuda.py)
# the graph route's gradients against the eager route's on the card, per field: a trip's
# gradient is summed before it joins the total, and the gathers' backward adds with atomics
GRAPH_REL_L1 = 1e-6


T0 = time.perf_counter()


def log(msg=""):
    print(msg, flush=True)


def phase(name):
    """A line with the seconds since the script started, at the start of each phase."""
    log(f"[{time.perf_counter() - T0:.1f} s] {name}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


SPIN_CYCLES = 20_000_000  # ~10 ms of the card: longer than the host needs to enqueue a round


def cuda_ms(fn, reps=20, rounds=7):
    """Median over `rounds` of the mean device time of `reps` calls, by CUDA events (after
    warm-up). A spin kernel holds the stream while the host enqueues the calls, so they run
    back to back and a short kernel's time is not the host's time to launch it."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)  # private to torch, the one spin kernel it ships
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return float(np.median(times))


def random_rays(b, seed, lo, hi, dev):
    rng = np.random.default_rng(seed)
    o = rng.uniform(lo, hi, size=(b, 3)).astype(np.float32)
    d = rng.normal(size=(b, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t = rng.uniform(size=b).astype(np.float32)
    return tuple(torch.from_numpy(a).to(dev) for a in (o, d, t))


def camera_rays(camera, dev, seed=0):
    from tpupt_torch.render.camera import generate_rays

    w, h = camera.image_width, camera.image_height
    pix = torch.arange(w * h, dtype=torch.int32, device=dev)
    o, d, t = generate_rays(camera.init(dev), pix // w, pix % w, pix, torch.zeros_like(pix), seed)
    return o.contiguous(), d.contiguous(), t.contiguous()


def bounce_rays(o, d, t, ns_raw, seed):
    """The batch that follows a batch of hits: origin o + t d, direction cosine-sampled about
    the shading normal (turned against the incoming ray) by a seeded generator, open seed.
    Lanes that missed keep their ray and are dead (t_in = 0), as closest_hit seeds them."""
    hit = t < 3e38
    n = ns_raw / ns_raw.norm(dim=1, keepdim=True).clamp_min(1e-20)
    n = torch.where((n * d).sum(dim=1, keepdim=True) > 0, -n, n)
    gen = torch.Generator(device=o.device)
    gen.manual_seed(seed)
    u = torch.rand((o.shape[0], 2), generator=gen, device=o.device)
    r, phi = u[:, 0:1].sqrt(), 2.0 * math.pi * u[:, 1:2]
    axis = torch.where(n[:, 0:1].abs() > 0.9, n.new_tensor([0.0, 1.0, 0.0]), n.new_tensor([1.0, 0.0, 0.0]))
    tx = torch.linalg.cross(axis, n)
    tx = tx / tx.norm(dim=1, keepdim=True).clamp_min(1e-20)
    ty = torch.linalg.cross(n, tx)
    nd = tx * (r * phi.cos()) + ty * (r * phi.sin()) + n * (1.0 - u[:, 0:1]).sqrt()
    nd = nd / nd.norm(dim=1, keepdim=True).clamp_min(1e-20)
    no = torch.where(hit[:, None], o + t[:, None] * d, o)
    nd = torch.where(hit[:, None], nd, d)
    t_in = torch.where(hit, 3e38, 0.0).to(torch.float32)
    return no.contiguous(), nd.contiguous(), t_in.contiguous()


def bound(flops, nbytes):
    """(least time in ms, what bounds it) for `flops` f32 operations moving `nbytes`."""
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


# ---------------------------------------------------------------------------
# stand-in assets
# ---------------------------------------------------------------------------


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


def write_stand_in_assets(root):
    """Scene 6's asset files as stand-ins -> {file: triangles}."""
    counts = {
        # centred and sized like the real meshes in everything_scene's frame
        "bunny.obj": _write_blob_obj(os.path.join(root, "bunny.obj"), 54, 46, (0.0, 0.07, 0.0), 0.07, 1, False),
        "spot.obj": _write_blob_obj(os.path.join(root, "spot.obj"), 58, 50, (0.0, 0.0, 0.0), 1.0, 2, True),
        "cow.obj": _write_blob_obj(os.path.join(root, "cow.obj"), 58, 50, (0.0, 0.0, 0.0), 1.2, 3, True),
    }
    _write_hdr(os.path.join(root, "grace_probe_latlong.hdr"))
    return counts


def write_hdr_env_assets(root):
    """The environment-map scene's stand-in sky, HDR_ENV_WH texels."""
    _write_hdr(os.path.join(root, "grace_probe_latlong.hdr"), *HDR_ENV_WH)


def bigmesh_scene(width, spp):
    """bench.py's bigmesh configuration on the port: bunny.obj subdivided 3 times."""
    from tpupt_torch.io.obj import load_obj, subdivide_mesh
    from tpupt_torch.render.camera import Camera
    from tpupt_torch.scene.builder import Diffuse, Scene
    from tpupt_torch.scenes import _asset

    s = Scene()
    s.add_mesh(subdivide_mesh(load_obj(_asset("bunny.obj")), 3), Diffuse((0.7, 0.7, 0.7)), scale=20.0)
    s.environment = (1.0, 1.0, 1.0)
    cam = Camera(
        aspect_ratio=1.0, image_width=width, samples_per_pixel=spp,
        max_depth=50, vfov=35.0, look_from=(0.0, 1.0, 6.0), look_at=(0.0, 1.0, 0.0),
        blur_strength=0.5, focal_length=5.0, defocus_angle=0.0,
    )
    return s, cam


# ---------------------------------------------------------------------------
# kernel checks
# ---------------------------------------------------------------------------


def check_k1(hit_kernel, sph, quad, rays, label):
    """Kernel vs plain on the card -> (mismatching lanes, max |t| error on hits). The plain
    version that tests every tile of spheres (no cull) must give the same bits too."""
    o, d, tm = rays
    kt, kk, ki = hit_kernel.closest_sphere_quad(o, d, tm, sph, quad)
    pt, pk, pi = hit_kernel.closest_sphere_quad_plain(o, d, tm, sph, quad)
    at, ak, ai = hit_kernel.closest_sphere_quad_plain(o, d, tm, sph, quad, cull=False)
    torch.cuda.synchronize()
    bad = (kt.view(torch.int32) != pt.view(torch.int32)) | (kk != pk) | (ki != pi)
    n_bad = int(bad.sum())
    n_cull = int(((at.view(torch.int32) != pt.view(torch.int32)) | (ak != pk) | (ai != pi)).sum())
    hits = pt < hit_kernel.BIG
    err = float((kt - pt).abs()[hits].max()) if bool(hits.any()) else 0.0
    log(f"K1 vs plain [{label}]: {o.shape[0]} rays, S={sph.shape[1]} Q={quad.shape[1]}, "
        f"hit share {float(hits.float().mean()):.4f}, mismatching lanes {n_bad}, max |dt| {err}; "
        f"plain with the tile cull vs without: {n_cull} lanes differ")
    return n_bad + n_cull, err


def k1_real_slots(sph, quad):
    """(real spheres, real quads) of tables in the reference layout: a sphere is real when
    r >= 0, a quad when its normal is not zero; the others are pad rows, which never hit."""
    return int((sph[6] >= 0).sum()), int((quad[0:3] != 0).any(dim=0).sum())


def k1_batches(hit_kernel, sd, cam, dev, seed):
    """K1's two batches on a scene -> {"camera": rays, "bounce": rays}: the camera rays, and
    the rays that follow their sphere and quad hits (bounce_rays about the geometric normal
    of the sphere or quad that K1 itself found; the ray's time is kept)."""
    o, d, tm = camera_rays(cam, dev)
    sph, quad = hit_kernel.tables(sd)
    t, kind, idx = hit_kernel.closest_sphere_quad(o, d, tm, sph, quad)
    i_s = idx.long().clamp_max(sd.sph_r.shape[0] - 1)
    i_q = idx.long().clamp_max(sd.quad_d.shape[0] - 1)
    center = sd.sph_c1[i_s] + (sd.sph_c2[i_s] - sd.sph_c1[i_s]) * tm[:, None]
    p = o + torch.where(t < 3e38, t, 0.0)[:, None] * d
    normal = torch.where((kind == 0)[:, None], p - center, sd.quad_n[i_q])
    no, nd, _ = bounce_rays(o, d, t, normal, seed)
    return {"camera": (o, d, tm), "bounce": (no, nd, tm)}


def time_k1(hit_kernel, shape, batch, sph, quad, rays):
    """Kernel and plain times of K1 on one batch, and its bound: the (ray, box), (ray, sphere)
    and (ray, quad) tests that the plain version counts on these rays (it skips the tiles of
    spheres whose box a ray misses, and the pad rows at the tables' tails), against the bytes.
    The bound on every real slot (no tile skipped) is given beside it
    -> dict(ms, plain_ms, bound_ms, bound_by, ...)."""
    o, d, tm = rays
    b = o.shape[0]
    k1 = torch.zeros(len(hit_kernel.K1_COUNTS), dtype=torch.int64, device=o.device)
    # the counts' cost: 7 pairs (without, with), each time a median of cuda_ms' rounds
    pairs = [(cuda_ms(lambda: hit_kernel.closest_sphere_quad(o, d, tm, sph, quad)),
              cuda_ms(lambda: hit_kernel.closest_sphere_quad(o, d, tm, sph, quad, counts=k1)))
             for _ in range(7)]
    ms, counting_ms = (float(np.median(x)) for x in zip(*pairs))
    cost = [100 * (c / m - 1) for m, c in pairs]
    q1, q2, q3 = statistics.quantiles(cost, n=4)
    plain_ms = cuda_ms(lambda: hit_kernel.closest_sphere_quad_plain(o, d, tm, sph, quad), reps=1, rounds=3)
    counts = {}
    t, _, _ = hit_kernel.closest_sphere_quad_plain(o, d, tm, sph, quad, counts=counts)
    k1.zero_()
    hit_kernel.closest_sphere_quad(o, d, tm, sph, quad, counts=k1)
    want = [counts.get(key, 0) for key in hit_kernel.K1_COUNTS]  # none where the table is one tile
    if k1.tolist() != want:
        raise SystemExit(f"chip_smoke: K1's counts of its tile cull [{shape}, {batch}] {k1.tolist()} differ "
                         f"from its plain version's {want}")
    real_s, real_q = k1_real_slots(sph, quad)
    flops = (counts["box_tests"] * K1_FLOPS_BOX + counts["sphere_tests"] * K1_FLOPS_SPHERE
             + counts["quad_tests"] * K1_FLOPS_QUAD)
    nbytes = b * K1_RAY_BYTES + 4 * (7 * real_s + 16 * real_q)
    bound_ms, bound_by = bound(flops, nbytes)
    all_ms, all_by = bound(b * (real_s * K1_FLOPS_SPHERE + real_q * K1_FLOPS_QUAD), nbytes)
    log(f"K1 [{shape}, {batch}] at B={b}, S={sph.shape[1]} ({real_s} real), Q={quad.shape[1]} "
        f"({real_q} real), hit share {float((t < 3e38).float().mean()):.4f}: kernel {ms:.4f} ms, counting "
        f"its tile cull {counting_ms:.4f} ms (over 7 pairs {q2:+.2f}%, quartiles {q1:+.2f}, {q3:+.2f}%), "
        f"plain {plain_ms:.4f} ms, "
        f"bound {bound_ms:.4f} ms ({bound_by}: {counts['box_tests']} box tests, "
        f"{counts['sphere_tests']} sphere tests = {counts['sphere_tests'] / max(b * real_s, 1):.4f} of "
        f"rays x real spheres ({counts['warp_sphere_tests'] / max(b * real_s, 1):.4f} when a warp of "
        f"32 rays sweeps a tile together), {counts['quad_tests']} quad tests, {flops:.3e} flop = "
        f"{1e3 * flops / PEAK_F32_FLOPS:.4f} ms, {nbytes:.3e} B = {1e3 * nbytes / PEAK_BYTES_PER_S:.4f} "
        f"ms); bound on every real slot {all_ms:.4f} ms ({all_by}); no single PyTorch call computes it")
    return dict(ms=ms, counting_ms=counting_ms, counting_cost_pct=cost, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, lanes=b,
                S=sph.shape[1], Q=quad.shape[1], real_S=real_s, real_Q=real_q,
                bound_ms_every_real_slot=all_ms, **counts)


def tri_args(sd):
    """(kernel, plain) callables of the scene's cluster route: f(o, d, t_in) -> (t, idx, aux)."""
    from tpupt_torch.ops import tri_kernel as TK

    if sd.has_tri_clusters:
        tables = (sd.tri_scl, sd.tri_cl, sd.tri_geo, sd.tri_attr)
        return (lambda o, d, t: TK.closest_tri_flat(o, d, t, 1e-3, *tables),
                lambda o, d, t, counts=None: TK.closest_tri_flat_plain(o, d, t, 1e-3, *tables, counts))
    tables = (sd.tri_scl, sd.tri_cl, sd.tri_geo, sd.tri_attr, sd.tri_sc_size)
    return (lambda o, d, t: TK.closest_tri_two_level(o, d, t, 1e-3, *tables),
            lambda o, d, t, counts=None: TK.closest_tri_two_level_plain(o, d, t, 1e-3, *tables, counts))


def check_tri(name, sd, rays, label):
    """Cluster kernel vs plain on the card -> (mismatching lanes, max |t| error on hits)."""
    kernel, plain = tri_args(sd)
    o, d, t_in = rays
    kt, ki, ka = kernel(o, d, t_in)
    pt, pi, pa = plain(o, d, t_in)
    torch.cuda.synchronize()
    bad = (kt.view(torch.int32) != pt.view(torch.int32)) | (ki != pi) | (ka["mat"] != pa["mat"])
    for k in ("ns_raw", "u", "v"):
        diff = ka[k].view(torch.int32) != pa[k].view(torch.int32)
        bad |= diff.any(dim=1) if diff.dim() == 2 else diff
    n_bad = int(bad.sum())
    hits = pt < 3e38
    err = float((kt - pt).abs()[hits].max()) if bool(hits.any()) else 0.0
    log(f"{name} vs plain [{label}]: {o.shape[0]} rays, {sd.tri_cl.shape[0]} clusters, hit share "
        f"{float(hits.float().mean()):.4f}, mismatching lanes {n_bad}, max |dt| {err}")
    return n_bad, err


def tri_test_rays(sd, b, seed, dev):
    """b random rays inside the meshes' bounds; seeds: 80% open, 10% short, 10% dead lanes."""
    box = sd.tri_cl[sd.tri_cl[:, 0] < 1e29]
    lo, hi = box[:, 0:3].min(0).values.cpu().numpy(), box[:, 3:6].max(0).values.cpu().numpy()
    o, d, _ = random_rays(b, seed, lo, hi, dev)
    rng = np.random.default_rng(seed + 1)
    u = rng.uniform(size=b)
    t_in = np.where(u < 0.8, 3e38, np.where(u < 0.9, rng.uniform(0, float((hi - lo).max()), b), 0.0))
    return o, d, torch.from_numpy(t_in.astype(np.float32)).to(dev)


def time_tri(name, sd, batch, rays):
    """Kernel and plain times on one batch at the main path's lane count, and the bound from
    the plain version's counted tests -> (ms, plain_ms, bound_ms, bound_by)."""
    kernel, plain = tri_args(sd)
    o, d, t_in = rays
    ms = cuda_ms(lambda: kernel(o, d, t_in))
    plain_ms = cuda_ms(lambda: plain(o, d, t_in), reps=1, rounds=3)
    counts = {}
    plain(o, d, t_in, counts)
    flops = counts["box_tests"] * TRI_FLOPS_BOX + counts["tri_tests"] * TRI_FLOPS_TRI
    tables = sum(x.numel() * 4 for x in (sd.tri_cl, sd.tri_scl, sd.tri_geo, sd.tri_attr))
    nbytes = o.shape[0] * TRI_RAY_BYTES + tables
    bound_ms, bound_by = bound(flops, nbytes)
    log(f"{name} [{batch}] at B={o.shape[0]} ({float((t_in > 0).float().mean()):.4f} alive), "
        f"{sd.tri_cl.shape[0]} clusters: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
        f"{bound_ms:.4f} ms ({bound_by}: {counts['box_tests']} box tests, {counts['tri_tests']} "
        f"triangle tests, {flops:.3e} flop, {nbytes:.3e} B; bytes alone "
        f"{1e3 * nbytes / PEAK_BYTES_PER_S:.4f} ms); no single PyTorch call computes it")
    return ms, plain_ms, bound_ms, bound_by


def bvh_args(sd):
    """(kernel, plain) callables of K4 on the scene's tree: f(o, d, t_in) -> (t, idx, aux)."""
    from tpupt_torch.ops import bvh_kernel
    from tpupt_torch.ops.bvh import bvh_closest_tri_plain

    tables = bvh_kernel.scene_nodes(sd)
    return (lambda o, d, t_in: bvh_kernel.closest_tri_bvh(o, d, t_in, 1e-3, *tables),
            lambda o, d, t_in, counts=None: bvh_closest_tri_plain(o, d, t_in, 1e-3, *tables, counts))


def check_bvh(sd, rays, label):
    """K4 vs plain on the card -> (mismatching lanes, max |t| error on hits): t's bits, idx
    and the four attribute fields on every lane."""
    kernel, plain = bvh_args(sd)
    kt, ki, ka = kernel(*rays)
    pt, pi, pa = plain(*rays)
    torch.cuda.synchronize()
    bad = (kt.view(torch.int32) != pt.view(torch.int32)) | (ki != pi) | (ka["mat"] != pa["mat"])
    for k in ("ns_raw", "u", "v"):
        diff = ka[k].view(torch.int32) != pa[k].view(torch.int32)
        bad |= diff.any(dim=1) if diff.dim() == 2 else diff
    n_bad = int(bad.sum())
    hits = pt < 3e38
    err = float((kt - pt).abs()[hits].max()) if bool(hits.any()) else 0.0
    log(f"K4 vs plain [{label}]: {rays[0].shape[0]} rays ({float((rays[2] > 0).float().mean()):.4f} alive), "
        f"{sd.bvh_skip.shape[0]} nodes over {sd.n_tris} triangle rows, hit share "
        f"{float(hits.float().mean()):.4f}, mismatching lanes {n_bad}, max |dt| {err}")
    return n_bad, err


def bvh_batches(sd, cam, dev, seed):
    """K4's batches on a scene compiled with bvh=True -> {"camera": rays, "bounce": rays}:
    the camera rays with an open seed, and the rays that follow their triangle hits
    (bounce_rays about the face normal of the triangle K4 found; lanes that missed keep
    their ray and get the seed 0, a dead lane, as closest_hit gives K2, K3 and K4)."""
    o, d, _ = camera_rays(cam, dev)
    t_in = torch.full((o.shape[0],), 3e38, device=dev)
    t, idx, _ = bvh_args(sd)[0](o, d, t_in)
    n = torch.linalg.cross(sd.tri_e1[idx.long()], sd.tri_e2[idx.long()])
    return {"camera": (o, d, t_in), "bounce": bounce_rays(o, d, t, n, seed)}


def check_stage_cond(dev):
    """K5 (the stage condition) against its plain version on the card at the lane counts and
    thresholds of the Cornell launch's stages, with every lane, some or none alive, and at
    thresholds on either side of the count; then its time at 360000 lanes
    -> (mismatches, max |error|, (ms, plain_ms, bound_ms, bound_by))."""
    from tpupt_torch.ops import loop_cond
    from tpupt_torch.render.integrator import compaction_thresholds

    rng = np.random.default_rng(40)
    b, k, spp_limit = 360000, 8, 32
    thresholds = compaction_thresholds(b)
    bad, err, cases = 0, 0.0, 0
    for n, thr in zip([b] + thresholds[:-1], thresholds):
        for p_alive in (0.0, 0.3, 1.0):
            alive = torch.from_numpy(rng.uniform(size=n) < p_alive).to(dev)
            sample = torch.from_numpy(rng.integers(0, k + 2, n).astype(np.int32)).to(dev)
            sample0 = torch.from_numpy(rng.integers(0, spp_limit + 8, n).astype(np.int32)).to(dev)
            n_work = int(loop_cond.stage_cond_plain(alive, sample, sample0, k, spp_limit, 0)[0])
            for t in sorted({thr, n_work, max(n_work - 1, 0)}):
                it = torch.zeros(1, dtype=torch.int64, device=dev)
                out = loop_cond.stage_cond(alive, sample, sample0, k, spp_limit, t, it, bump=True)
                ref = loop_cond.stage_cond_plain(alive, sample, sample0, k, spp_limit, t)
                torch.cuda.synchronize()
                e = float((out - ref).abs().max()) + abs(int(it) - 1)
                bad += int(e != 0)
                err = max(err, e)
                cases += 1
    n = b
    alive = torch.from_numpy(rng.uniform(size=n) < 0.5).to(dev)
    sample = torch.from_numpy(rng.integers(0, k + 2, n).astype(np.int32)).to(dev)
    sample0 = torch.from_numpy(rng.integers(0, spp_limit + 8, n).astype(np.int32)).to(dev)
    out = torch.empty(2, dtype=torch.int64, device=dev)
    scratch = torch.zeros(2, dtype=torch.int32, device=dev)
    ms = cuda_ms(lambda: loop_cond.stage_cond(alive, sample, sample0, k, spp_limit, thresholds[0], out=out,
                                              scratch=scratch))
    plain_ms = cuda_ms(lambda: loop_cond.stage_cond_plain(alive, sample, sample0, k, spp_limit, thresholds[0]))
    nbytes = n * (1 + 4 + 4) + 2 * 8  # alive, sample, sample0 in; the count and the decision out
    bound_ms, bound_by = bound(0, nbytes)
    log(f"K5 stage_cond: {cases} cases on Cornell's stages ({[b] + thresholds[:-1]} lanes), {bad} mismatches, "
        f"max |error| {err}; at B={n}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
        f"({bound_by}: {nbytes} B; integer work only); no single PyTorch call computes it")
    return bad, err, (ms, plain_ms, bound_ms, bound_by)


def check_grad_conds(dev):
    """K5's gradient modes against their plain versions on the card: the gate at the lane
    counts of the `grads` and `grads 600` passes (65536, 360000) at every trip of two chunks
    with segments of 1, 3 and 8, lanes with work and without; the countdown down a chunk.
    Then their times at 65536 lanes -> ({mode: mismatches}, {mode: max |error|}, {mode: (ms,
    plain_ms, bound_ms, bound_by)}), mode "gate" or "countdown"."""
    from tpupt_torch.ops import loop_cond

    rng = np.random.default_rng(41)
    k, spp, depth = 8, 32, 50
    bad, err, cases = {"gate": 0, "countdown": 0}, {"gate": 0.0, "countdown": 0.0}, 0
    for n in (65536, 360000):
        sample0 = torch.from_numpy(rng.integers(0, spp, n).astype(np.int32)).to(dev)
        for segment in (1, 3, 8):
            cap = -(-(k * depth) // segment) * segment
            for p_alive, s in ((0.2, 1), (0.0, k)):
                alive = torch.from_numpy(rng.uniform(size=n) < p_alive).to(dev)
                sample = torch.full((n,), s, dtype=torch.int32, device=dev)
                for c0 in (0, cap - 2 * segment):
                    chunk = torch.tensor([c0, c0 + 2 * segment], device=dev)
                    for t in range(c0, c0 + 2 * segment + 1):
                        for bump in (False, True):
                            trips = torch.tensor([t - bump], device=dev)
                            trips_ref = trips.clone()
                            out = loop_cond.grad_gate(alive, sample, sample0, k, spp, segment, cap, trips, chunk,
                                                      bump)
                            ref = loop_cond.grad_gate_plain(alive, sample, sample0, k, spp, segment, cap,
                                                            trips_ref, chunk, bump)
                            e = float((out - ref).abs().max()) + abs(int(trips) - int(trips_ref))
                            bad["gate"] += int(e != 0)
                            err["gate"] = max(err["gate"], e)
                            cases += 1
    chunk = torch.tensor([40, 48], device=dev)
    index, replays = torch.tensor([47], device=dev), torch.zeros(1, dtype=torch.int64, device=dev)
    index_ref, replays_ref = index.clone(), replays.clone()
    for bump in [False] + [True] * 9:
        out = loop_cond.grad_countdown(index, chunk, replays, bump)
        ref = loop_cond.grad_countdown_plain(index_ref, chunk, replays_ref, bump)
        e = float((out - ref).abs().max()) + abs(int(index) - int(index_ref)) + abs(int(replays) - int(replays_ref))
        bad["countdown"] += int(e != 0)
        err["countdown"] = max(err["countdown"], e)
        cases += 1
    n = 65536
    alive = torch.from_numpy(rng.uniform(size=n) < 0.5).to(dev)
    sample = torch.from_numpy(rng.integers(0, k + 2, n).astype(np.int32)).to(dev)
    sample0 = torch.from_numpy(rng.integers(0, spp, n).astype(np.int32)).to(dev)
    trips, chunk = torch.tensor([8], device=dev), torch.tensor([0, 64], device=dev)
    out = torch.empty(2, dtype=torch.int64, device=dev)
    scratch = torch.zeros(2, dtype=torch.int32, device=dev)
    timing = {}
    ms = cuda_ms(lambda: loop_cond.grad_gate(alive, sample, sample0, k, spp, 8, 400, trips, chunk, out=out,
                                             scratch=scratch))
    plain_ms = cuda_ms(lambda: loop_cond.grad_gate_plain(alive, sample, sample0, k, spp, 8, 400, trips, chunk))
    nbytes = n * (1 + 4 + 4) + 8 + 16 + 16  # the lanes, the trip counter, the chunk in; the count, go out
    timing["gate"] = (ms, plain_ms, *bound(0, nbytes))
    ms = cuda_ms(lambda: loop_cond.grad_countdown(index, chunk, replays, out=out))
    plain_ms = cuda_ms(lambda: loop_cond.grad_countdown_plain(index, chunk, replays))
    timing["countdown"] = (ms, plain_ms, *bound(0, 8 + 16 + 8 + 16))  # index, chunk, replays in; index, go out
    log(f"K5 grad_gate / grad_countdown: {cases} cases at 65536 and 360000 lanes, mismatches {bad}, max |error| "
        f"{err}; at B={n}: gate kernel {timing['gate'][0]:.4f} ms, plain {timing['gate'][1]:.4f} ms, bound "
        f"{timing['gate'][2]:.6f} ms (bytes: {nbytes} B); countdown kernel {timing['countdown'][0]:.4f} ms, plain "
        f"{timing['countdown'][1]:.4f} ms, bound {timing['countdown'][2]:.2e} ms (bytes: 48 B); integer work only, "
        f"no single PyTorch call computes either")
    return bad, err, timing


def wavefront_states(compiled, cam, dev):
    """The Cornell box's stage runner at WAVEFRONT's size (a lane a pixel), driven as
    StreamStages.run drives it on the card -> (runner, {label: (stage, state)}): copies of the
    state of stage 0 and of the last stage, each WAVEFRONT["iterations"] into the stage."""
    from tpupt_torch.render import integrator as I

    w = WAVEFRONT["width"]
    b, spp, c = w * w, WAVEFRONT["spp"], cam.init(dev)
    st = I.StreamStages(compiled.data, c, b, spp, spp, cam.max_depth, compiled.has_lights, dev)
    pix = torch.arange(b, dtype=torch.int32, device=dev)
    st.set_inputs(pix, pix // w, pix % w, torch.zeros_like(pix), 5, c)
    st.reset()
    last, states = len(st.states) - 1, {}
    for i in range(last + 1):
        n = 0
        while bool(st.cond(i, n > 0)[1]):
            st.step(i)
            n += 1
            if n == WAVEFRONT["iterations"] and i in (0, last):
                states[f"stage {i}, {st.sizes[i]} lanes"] = (i, {k: v.clone() for k, v in st.states[i].items()})
                if i == last:
                    break
        if i < last:
            st.compact(i)
    if len(states) != 2:
        raise SystemExit(f"chip_smoke: the Cornell runner did not reach {WAVEFRONT['iterations']} iterations of "
                         f"its first and last stages ({list(states)})")
    return st, states


def _step_from(st, i, state, fused):
    """One iteration of stage i of the runner from a copy of `state` -> (state after, rays)."""
    s = {k: v.clone() for k, v in state.items()}
    kept, rays0 = (st.states[i], st.fused), int(st.rays)
    st.states[i], st.fused = s, fused
    try:
        st.step(i)
    finally:
        st.states[i], st.fused = kept
    return s, int(st.rays) - rays0


def check_wavefront(st, states):
    """KW1 and KW2 against their plain version, _stream_step: from each state one iteration
    by the kernels (the hit kernels between them) and one by the plain route. A field differs
    on a lane where its bits do; regeneration's own fields (time, sample, cur_sample) and the
    ray count are KW1's, the rest KW2's -> ({"KW1", "KW2"}: lanes off, {...}: max |error|)."""
    from tpupt_torch.render.integrator import STEP_KEYS

    own = ("time", "sample", "cur_sample")
    bad, err = {"KW1": 0, "KW2": 0}, {"KW1": 0.0, "KW2": 0.0}
    for label, (i, state) in states.items():
        plain, rays_p = _step_from(st, i, state, False)
        fused, rays_f = _step_from(st, i, state, True)
        off = {}
        for key in STEP_KEYS:
            a, b = plain[key], fused[key]
            bits = (a.view(torch.int32) != b.view(torch.int32)) if a.is_floating_point() else a != b
            off[key] = int(bits.reshape(a.shape[0], -1).any(1).sum())
            name = "KW1" if key in own else "KW2"
            bad[name] += off[key]
            if off[key]:
                e = float(torch.nan_to_num((a.double() - b.double()).abs(), nan=math.inf).max())
                err[name] = max(err[name], e)
        bad["KW1"] += abs(rays_f - rays_p)
        log(f"KW1/KW2 [{label}]: one fused iteration against _stream_step, lanes off by field {off}, rays "
            f"{rays_f} / {rays_p}")
    return bad, err


def graph_ms(fn, reps=50, rounds=7):
    """Device ms of `fn` captured as one CUDA graph (on a stream of its own, as a capture must
    be): the median over `rounds` of the mean of `reps` replays back to back behind the spin
    kernel (cuda_ms)."""
    from tpupt_torch.render.graph import _capture

    side, caller = torch.cuda.Stream(), torch.cuda.current_stream()
    side.wait_stream(caller)
    with torch.cuda.stream(side):
        g, _ = _capture("a timed graph", fn, None, keep_graph=False)
    caller.wait_stream(side)
    return cuda_ms(g.replay, reps=reps, rounds=rounds)


def time_wavefront(st, states):
    """Each kernel, the fused iteration and the plain one (_stream_step) on each state, as CUDA
    graphs behind a restore of the state they write (the restore's own graph subtracted); the
    bytes bounds from the state's lanes -> {label: numbers}."""
    from tpupt_torch.ops import wavefront_kernel as W
    from tpupt_torch.ops.intersect import hit_kernels
    from tpupt_torch.render.integrator import T_MAX, T_MIN

    out = {}
    for label, (i, state) in states.items():
        n = state["alive"].shape[0]
        s = {k: v.clone() for k, v in state.items()}

        def restore(src):
            for k, v in s.items():
                v.copy_(src[k])

        need = int(((~s["alive"]) & (s["sample"] < st.k) & ((s["sample0"] + s["sample"]) < st.spp_limit)).sum())
        rays = torch.zeros(1, dtype=torch.int64, device=s["alive"].device)
        t_restore = graph_ms(lambda: restore(state))
        regen_ms = graph_ms(lambda: (restore(state), W.regenerate(s, st.cam, st.seed, st.k, st.spp_limit,
                                                                   rays))) - t_restore
        restore(state)
        W.regenerate(s, st.cam, st.seed, st.k, st.spp_limit, rays)
        after = {k: v.clone() for k, v in s.items()}
        live = int(after["alive"].sum())
        hits = hit_kernels(st.sd, s["o"], s["d"], s["time"], T_MIN, T_MAX, s["alive"])
        shade_ms = graph_ms(lambda: (restore(after), W.shade(s, st.sd, hits, st.seed, st.max_depth, st.has_lights,
                                                             st.p_light, st.p_bsdf))) - t_restore
        kept = (st.states[i], st.fused)
        st.states[i] = s
        try:
            st.fused = True
            fused_ms = graph_ms(lambda: (restore(state), st.step(i))) - t_restore
            st.fused = False
            restore(state)
            st.step(i)  # the plain route once outside a capture: its constants on the card
            plain_ms = graph_ms(lambda: (restore(state), st.step(i)), reps=10, rounds=3) - t_restore
        finally:
            st.states[i], st.fused = kept
        regen_bytes = n * KW1_LANE_BYTES + need * KW1_NEW_BYTES
        shade_bytes = n * KW2_LANE_BYTES + live * KW2_LIVE_BYTES
        out[label] = dict(lanes=n, regenerated=need, live=live, restore_ms=t_restore,
                          KW1=dict(ms=regen_ms, bytes=regen_bytes, bound_ms=bound(0, regen_bytes)[0]),
                          KW2=dict(ms=shade_ms, bytes=shade_bytes, bound_ms=bound(0, shade_bytes)[0]),
                          iteration_ms=fused_ms, plain_iteration_ms=plain_ms)
        log(f"KW1/KW2 [{label}]: {need} lanes regenerated, {live} live after; KW1 {regen_ms:.4f} ms (bytes bound "
            f"{out[label]['KW1']['bound_ms']:.4f} ms, {regen_bytes} B), KW2 {shade_ms:.4f} ms (bytes bound "
            f"{out[label]['KW2']['bound_ms']:.4f} ms, {shade_bytes} B); the iteration {fused_ms:.4f} ms fused, "
            f"{plain_ms:.4f} ms by _stream_step (x{plain_ms / fused_ms:.1f})")
    return out


def masked_rays(rays):
    """A batch with t_in = 0 on every other lane (dead) and NaN in the origin or the
    direction of one lane in 61."""
    o, d, t_in = (x.clone() for x in rays)
    lane = torch.arange(o.shape[0], device=o.device)
    t_in[lane % 2 == 0] = 0.0
    o[lane % 61 == 1, 0] = float("nan")
    d[lane % 61 == 3, 2] = float("nan")
    return o, d, t_in


def film_launch(rng, order, lo, pb):
    """A launch of the film's add over the pixels order[lo : lo + pb] -> (out [pb, 3] f32,
    ids [pb] i32, n_valid): radiance sums with NaN, +-inf, -0.0 and negative values among the
    real lanes; NaN in the padded ones, whose id 0 would show any add they made at pixel 0."""
    n_valid = min(pb, order.shape[0] - lo)
    ids = np.zeros(pb, np.int32)
    ids[:n_valid] = order[lo : lo + n_valid]
    out = (rng.exponential(size=(pb, 3)) * 10.0 ** rng.integers(-3, 3)).astype(np.float32)
    for value, share in ((np.nan, 1e-5), (np.inf, 1e-5), (-np.inf, 1e-5), (-0.0, 1e-3), (-1.0, 1e-3)):
        out[rng.random(out.shape) < share] = value
    out[n_valid:] = np.nan
    return out, ids, n_valid


def bits_differ(a, b) -> int:
    """Elements of two float arrays of one shape whose bits differ, a NaN's payload aside (the
    card's arithmetic makes the canonical NaN, the host's keeps an operand's)."""
    a, b = np.asarray(a), np.asarray(b)
    nan = np.isnan(a) & np.isnan(b)
    return int(((a.view(f"u{a.itemsize}") != b.view(f"u{b.itemsize}")) & ~nan).sum())


def tonemap_edges(spp):
    """[n, 3] float64 films whose means over spp sit on the tonemap's edges: (m/256)^2, where
    g * 256 is the integer m, and the doubles beside it; 0.999^2 and beside; NaN, +-inf,
    -0.0, negatives, tiny and huge values."""
    at = (np.arange(257, dtype=np.float64) / 256.0) ** 2
    c = 0.999 ** 2
    mean = np.concatenate([at, np.nextafter(at, -np.inf), np.nextafter(at, np.inf),
                           [c, np.nextafter(c, 0.0), np.nextafter(c, 2.0), np.nan, np.inf, -np.inf, -0.0,
                            -1.0, 5e-324, 1e300]])
    mean = mean[: len(mean) // 3 * 3]
    with np.errstate(over="ignore"):
        return (mean * spp).reshape(-1, 3)


def check_film(dev):
    """film_kernel.add over the launches of each FILM_SHAPES frame, and film_kernel.resolve of
    the film they make and of the tonemap's edges, on the card against add_plain and
    resolve_plain on the same inputs copied to the CPU -> (mismatches by kernel, elements
    compared). A mismatch is an element whose bits differ, a NaN's payload aside."""
    from tpupt_torch.ops import film_kernel
    from tpupt_torch.render.renderer import _pixel_order

    bad = {"film add": 0, "film resolve": 0}
    compared = {"film add": 0, "film resolve": 0}
    for seed, (shape, (w, h, spp)) in enumerate(FILM_SHAPES.items()):
        rng = np.random.default_rng(40 + seed)
        order = _pixel_order(w, h)
        npix = order.shape[0]
        card = torch.zeros((npix, 3), dtype=torch.float64, device=dev)
        plain = torch.zeros((npix, 3), dtype=torch.float64)
        launches = [(0, npix)] + [(lo, FILM_BLOCK) for lo in range(0, npix, FILM_BLOCK)]
        for lo, pb in launches:
            out, ids, n_valid = film_launch(rng, order, lo, pb)
            film_kernel.add(card, torch.from_numpy(out).to(dev), torch.from_numpy(ids).to(dev), n_valid)
            film_kernel.add_plain(plain, torch.from_numpy(out), torch.from_numpy(ids), n_valid)
        n = bits_differ(card.cpu().numpy(), plain.numpy())
        bad["film add"] += n
        compared["film add"] += plain.numel()
        films = {"its launches": plain, "the tonemap's edges": torch.from_numpy(tonemap_edges(spp))}
        for what, film in films.items():
            img_c, mean_c = film_kernel.resolve(film.to(dev), spp)
            img_p, mean_p = film_kernel.resolve_plain(film, spp)
            m = int((img_c.cpu() != img_p).sum()) + bits_differ(mean_c.cpu().numpy(), mean_p.numpy())
            bad["film resolve"] += m
            compared["film resolve"] += 2 * film.numel()
            log(f"film [{shape}, {what}]: resolve at {spp} spp over {film.shape[0]} pixels, image and mean "
                f"against the plain version: {m} elements differ")
        log(f"film [{shape} {w}x{h}]: add over {len(launches)} launches (the whole frame, then "
            f"{len(launches) - 1} blocks of {FILM_BLOCK} pixels, the last with {FILM_BLOCK - (npix % FILM_BLOCK)} "
            f"padded lanes), {int(np.isnan(plain.numpy()).any(-1).sum())} pixels NaN: {n} elements differ "
            f"from the plain version")
    return bad, compared


def time_film(dev):
    """The film's kernels at each FILM_SHAPES frame: add of one launch over the whole frame and
    resolve of the frame, kernel ms (cuda_ms), the plain versions' ms (add_plain on the card;
    resolve_plain on the host, numpy, as render_image resolved before it had the kernel) and the
    bytes bound -> {shape: {"film add": numbers, "film resolve": numbers}}."""
    from tpupt_torch.ops import film_kernel
    from tpupt_torch.render.renderer import _pixel_order

    res = {}
    for shape, (w, h, spp) in FILM_SHAPES.items():
        npix = w * h
        rng = np.random.default_rng(7)
        film = torch.from_numpy(rng.exponential(size=(npix, 3)) * spp).to(dev)
        out = torch.from_numpy(rng.exponential(size=(npix, 3)).astype(np.float32)).to(dev)
        ids = torch.from_numpy(_pixel_order(w, h).copy()).to(dev)
        add_ms = cuda_ms(lambda: film_kernel.add(film, out, ids, npix))
        add_plain_ms = cuda_ms(lambda: film_kernel.add_plain(film, out, ids, npix), reps=5, rounds=3)
        resolve_ms = cuda_ms(lambda: film_kernel.resolve(film, spp))
        host = film.cpu()
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            film_kernel.resolve_plain(host, spp)
            times.append(1e3 * (time.perf_counter() - t0))
        nums = {}
        for k, ms, plain_ms, nbytes in (("film add", add_ms, add_plain_ms, npix * FILM_ADD_BYTES),
                                        ("film resolve", resolve_ms, float(np.median(times)),
                                         npix * FILM_RESOLVE_BYTES)):
            nums[k] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound(0, nbytes)[0], bytes=nbytes, pixels=npix)
        res[shape] = nums
        log(f"film [{shape} {w}x{h}]: add {add_ms:.4f} ms (bytes bound {nums['film add']['bound_ms']:.4f} ms, "
            f"{nums['film add']['bytes']} B), add_plain on the card {add_plain_ms:.4f} ms; resolve "
            f"{resolve_ms:.4f} ms (bytes bound {nums['film resolve']['bound_ms']:.4f} ms, "
            f"{nums['film resolve']['bytes']} B), resolve_plain on the host {nums['film resolve']['plain_ms']:.3f} ms")
    return res


def time_bvh(shape, batch, sd, rays):
    """K4's kernel and plain times on one batch, its bound from the binary node visits and
    triangle tests that the plain version counts on these rays (at K2/K3's flops a box and
    a triangle test) against the ray bytes, the nodes, the triangle rows and the winners'
    attribute rows, and the counts of the kernel's own walk (wide-node fetches, triangle
    tests, the deepest stack)."""
    from tpupt_torch.ops import bvh_kernel

    kernel, plain = bvh_args(sd)
    b = rays[0].shape[0]
    ms = cuda_ms(lambda: kernel(*rays))
    plain_ms = cuda_ms(lambda: plain(*rays), reps=1, rounds=3)
    counts = {}
    t, _, _ = plain(*rays, counts)
    walk = bvh_kernel.walk_counts(*rays, 1e-3, *bvh_kernel.scene_nodes(sd))
    hits = int((t < 3e38).sum())
    flops = counts["box_tests"] * TRI_FLOPS_BOX + counts["tri_tests"] * TRI_FLOPS_TRI
    nbytes = (b * TRI_RAY_BYTES + sd.bvh_skip.shape[0] * BVH_NODE_BYTES + sd.n_tris * BVH_TRI_BYTES
              + hits * BVH_ATTR_BYTES)
    bound_ms, bound_by = bound(flops, nbytes)
    log(f"K4 [{shape}, {batch}] at B={b} ({float((rays[2] > 0).float().mean()):.4f} alive), "
        f"{sd.bvh_skip.shape[0]} nodes, hit share {hits / b:.4f}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"bound {bound_ms:.4f} ms ({bound_by}: {counts['box_tests']} node visits = "
        f"{counts['box_tests'] / b:.2f} a ray, {counts['tri_tests']} triangle tests = "
        f"{counts['tri_tests'] / b:.2f} a ray, {flops:.3e} flop, {nbytes:.3e} B; bytes alone "
        f"{1e3 * nbytes / PEAK_BYTES_PER_S:.4f} ms); the kernel's walk: {walk['node_fetches'] / b:.2f} "
        f"wide-node fetches, {walk['tri_tests'] / b:.2f} triangle tests and {walk['steps'] / b:.2f} steps a "
        f"ray, the longest walk {walk['longest_walk']} steps, deepest stack {walk['deepest_stack']}; no "
        f"single PyTorch call computes it")
    if walk["tri_tests"] != counts["tri_tests"]:
        raise SystemExit(f"chip_smoke: K4's walk tested {walk['tri_tests']} triangles, the binary walk "
                         f"{counts['tri_tests']}")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, lanes=b,
                nodes=sd.bvh_skip.shape[0], hit_share=hits / b, **counts,
                wide_fetches=walk["node_fetches"], steps=walk["steps"], longest_walk=walk["longest_walk"],
                deepest_stack=walk["deepest_stack"])


def routes(sd):
    """The scene's SceneData with each triangle route's flags: bvh, clusters (flat or
    two-level, as packed), mxu and sweep."""
    off = dict(has_tri_bvh=False, has_tri_clusters=False, has_tri_clusters_hbm=False, has_tri_mxu=False)
    flat = sd.tri_sc_size == 64
    return {"bvh": dataclasses.replace(sd, **dict(off, has_tri_bvh=True)),
            "clusters": dataclasses.replace(sd, **dict(off, has_tri_clusters=flat, has_tri_clusters_hbm=not flat)),
            "mxu": dataclasses.replace(sd, **dict(off, has_tri_mxu=True)),
            "sweep": dataclasses.replace(sd, **off)}


def check_mxu(sd, rays, k2_ms):
    """The matmul sweep (the reference's MXU path, torch.matmul in full float32) against the
    dense sweep through closest_hit on one batch: valid masks agree on more than
    MXU_VALID_SHARE of lanes, t within MXU_TOL where both hit. Timed beside K2."""
    from tpupt_torch.ops.intersect import closest_hit

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    o, d = rays[0], rays[1]
    tm = torch.zeros_like(o[:, 0])
    r = routes(sd)
    h_mxu = closest_hit(r["mxu"], o, d, tm, 1e-3, 3e38)
    h_swp = closest_hit(r["sweep"], o, d, tm, 1e-3, 3e38)
    torch.cuda.synchronize()
    agree = float((h_mxu.valid == h_swp.valid).float().mean())
    both = h_mxu.valid & h_swp.valid
    t_ok = bool(torch.allclose(h_mxu.t[both], h_swp.t[both], rtol=MXU_TOL, atol=MXU_TOL))
    torch.cuda.reset_peak_memory_stats()
    mxu_ms = cuda_ms(lambda: closest_hit(r["mxu"], o, d, tm, 1e-3, 3e38), reps=1, rounds=3)
    peak = torch.cuda.max_memory_allocated() / 2**30
    sweep_ms = cuda_ms(lambda: closest_hit(r["sweep"], o, d, tm, 1e-3, 3e38), reps=1, rounds=3)
    log(f"matmul sweep (MXU path) [scene 6 stand-in, camera] at B={o.shape[0]}, {sd.n_tris} triangle rows: "
        f"valid masks agree on {agree:.6f} of lanes (limit > {MXU_VALID_SHARE}), t within {MXU_TOL} where both "
        f"hit: {t_ok}; closest_hit {mxu_ms:.3f} ms (peak {peak:.2f} GiB), dense sweep {sweep_ms:.3f} ms, K2 "
        f"{k2_ms:.4f} ms on the same rays")
    if agree <= MXU_VALID_SHARE or not t_ok:
        raise SystemExit("chip_smoke: the matmul sweep disagrees with the dense sweep")
    return dict(agree=agree, t_within_tol=t_ok, ms=mxu_ms, sweep_ms=sweep_ms, k2_ms=k2_ms, peak_gib=peak,
                lanes=o.shape[0])


# ---------------------------------------------------------------------------
# renders
# ---------------------------------------------------------------------------


def image_stats(mean):
    """(finite share, mean radiance over finite pixels, its standard error)."""
    px = mean.reshape(-1, 3)
    fin = np.isfinite(px).all(axis=1)
    vals = px[fin].mean(axis=1)
    return float(fin.mean()), float(vals.mean()), float(vals.std() / math.sqrt(max(len(vals), 1)))


ROUTES = {}  # each compared render: the graph route's numbers and the eager route's
RENDER_GRADS = {}  # render_grads by the graphs and by the eager route


def render(label, compiled, cam, counters, kernel_ms, compare=True):
    """One render_image run with the kernel counts zeroed first -> (mean, stats, launches).

    On the card the launches run as graphs; K5, the stage condition, launches in every
    render. compare: render again by the eager loop (the graphs' plain version, its
    launches not counted), which must give the same film bit for bit, rays and iterations."""
    from tpupt_torch.render.renderer import plain_launches, render_image

    counters = list(counters) + ["K5", "KW1", "KW2"]
    zero_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated() / 2**30  # scenes and the graphs kept on them
    _, mean, st = render_image(compiled, cam, seed=0, progress=False)
    torch.cuda.synchronize()
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    fin, mu, _ = image_stats(mean)
    shares = ", ".join(
        f"{k} {launches[k]} launches (<= {100 * launches[k] * kernel_ms[k] / 1e3 / st.wall_s:.2f}% of wall)"
        for k in counters
    )
    replay_ms = 1e3 * (st.wall_s - st.capture_s) / max(st.iterations, 1)
    log(f"render {label} {cam.image_width}x{cam.image_height} {cam.samples_per_pixel} spp max_depth "
        f"{cam.max_depth} on cuda (graphs): {st.wall_s:.3f} s ({st.capture_s:.3f} s capture and "
        f"instantiation), {st.paths} paths, {st.paths_per_s:.4e} paths/s, {st.rays} rays, "
        f"{st.rays_per_s:.4e} rays/s, {st.launches} launches, {st.iterations} wavefront iterations "
        f"({1e3 * st.wall_s / max(st.iterations, 1):.3f} ms each, {replay_ms:.3f} ms without the "
        f"capture), peak memory {peak:.3f} GiB ({held:.3f} GiB held before the call); {shares}; finite share "
        f"{fin:.6f}, mean radiance {mu:.6f}")
    for k in counters:
        if launches[k] == 0:
            raise SystemExit(f"chip_smoke: the {label} render never launched {k}")
    if "K4" in counters and launches["K4"] != st.iterations:  # one closest_hit an iteration
        raise SystemExit(f"chip_smoke: the {label} render launched K4 {launches['K4']} times in "
                         f"{st.iterations} iterations")
    if not launches["KW1"] == launches["KW2"] == st.fused_iterations == st.iterations:
        raise SystemExit(f"chip_smoke: the {label} render's iterations must each launch KW1 and KW2 once: "
                         f"{launches['KW1']}, {launches['KW2']}, {st.fused_iterations} fused of {st.iterations}")
    if launches["film add"] != st.launches or launches["film resolve"] != 1:  # the film on the card
        raise SystemExit(f"chip_smoke: the {label} render's {st.launches} launches added the film "
                         f"{launches['film add']} times and resolved it {launches['film resolve']} times")
    if mean.shape != (cam.image_height, cam.image_width, 3) or fin < 0.99 or not mu > 0.0:
        raise SystemExit(f"chip_smoke: the {label} film is wrong: shape {mean.shape}, finite share "
                         f"{fin}, mean {mu}")
    if compare:
        torch.cuda.reset_peak_memory_stats()
        with plain_launches():
            _, mean_e, st_e = render_image(compiled, cam, seed=0, progress=False)
        torch.cuda.synchronize()
        peak_e = torch.cuda.max_memory_allocated() / 2**30
        equal = (np.array_equal(mean, mean_e, equal_nan=True) and st.rays == st_e.rays
                 and st.iterations == st_e.iterations)
        log(f"render {label}, eager loop (plain version): {st_e.wall_s:.3f} s, {st_e.paths_per_s:.4e} "
            f"paths/s, {st_e.iterations} iterations ({1e3 * st_e.wall_s / max(st_e.iterations, 1):.3f} ms "
            f"each), peak memory {peak_e:.3f} GiB; graphs against it: film bit-equal, rays and iterations "
            f"equal {equal}; paths/s x{st.paths_per_s / st_e.paths_per_s:.3f}")
        ROUTES[label] = dict(
            graphs=dict(wall_s=st.wall_s, capture_s=st.capture_s, paths_per_s=st.paths_per_s,
                        iterations=st.iterations, ms_per_iteration=1e3 * st.wall_s / max(st.iterations, 1),
                        replay_ms_per_iteration=replay_ms, peak_gib=peak, held_gib=held, launches=st.launches),
            eager=dict(wall_s=st_e.wall_s, paths_per_s=st_e.paths_per_s, iterations=st_e.iterations,
                       ms_per_iteration=1e3 * st_e.wall_s / max(st_e.iterations, 1), peak_gib=peak_e),
            bit_equal=equal, rays=st.rays)
        if not equal:
            diff = np.abs(mean.astype(np.float64) - mean_e)
            raise SystemExit(f"chip_smoke: the {label} render differs between the graphs and the eager loop: "
                             f"rays {st.rays} vs {st_e.rays}, iterations {st.iterations} vs {st_e.iterations}, "
                             f"{int((diff > 0).any(-1).sum())} pixels differ, max {np.nanmax(diff):.3e}")
        ROUTES[label]["second call"] = second_call(label, compiled, cam, counters)
    return mean, st, launches


def second_call(label, compiled, cam, counters):
    """render_image again at seed 1, the counts zeroed just before and read just after: it
    replays the launch graphs kept on the compiled scene (capture_s 0, so no eager first
    iteration either), and its film is the eager loop's at seed 1, bit for bit -> numbers."""
    from tpupt_torch.render.renderer import plain_launches, render_image

    torch.cuda.synchronize()
    zero_counts()
    _, mean, st = render_image(compiled, cam, seed=1, progress=False)
    torch.cuda.synchronize()
    launches = read_counts()
    with plain_launches():
        _, mean_e, st_e = render_image(compiled, cam, seed=1, progress=False)
    equal = (np.array_equal(mean, mean_e, equal_nan=True) and st.rays == st_e.rays
             and st.iterations == st_e.iterations)
    log(f"render {label}, second call (seed 1, kept graphs): {st.wall_s:.3f} s, capture {st.capture_s:.3f} s, "
        f"{st.paths_per_s:.4e} paths/s, {st.iterations} iterations ({1e3 * st.wall_s / max(st.iterations, 1):.3f} "
        f"ms each), launches {launches}; the eager loop at seed 1 {st_e.wall_s:.3f} s; film bit-equal, rays and "
        f"iterations equal {equal}")
    if st.capture_s != 0.0 or not equal or any(launches[k] == 0 for k in counters):
        raise SystemExit(f"chip_smoke: the {label} render's second call captured ({st.capture_s} s), launched "
                         f"{launches} or differs from the eager loop at seed 1 (equal {equal})")
    return dict(wall_s=st.wall_s, capture_s=st.capture_s, paths_per_s=st.paths_per_s, iterations=st.iterations,
                ms_per_iteration=1e3 * st.wall_s / max(st.iterations, 1), launches=launches,
                eager_wall_s=st_e.wall_s, eager_paths_per_s=st_e.paths_per_s, bit_equal=equal)


def compare_small(label, build, dev, tol_mean=0.01, bvh=None):
    """A 32 px / 4 spp render on cuda against the same render on the cpu: at least 95% of
    pixels within rtol 1e-3 / atol 1e-4 and image means within tol_mean. bvh as in
    Scene.compile."""
    from tpupt_torch.render.renderer import render_image

    scene, cam = build(32, 4)
    _, m_cpu, _ = render_image(scene.compile(device="cpu", bvh=bvh), cam, seed=0, progress=False)
    _, m_gpu, _ = render_image(scene.compile(device=dev, bvh=bvh), cam, seed=0, progress=False)
    close = float(np.isclose(m_gpu, m_cpu, rtol=1e-3, atol=1e-4, equal_nan=True).all(-1).mean())
    _, mean_g, _ = image_stats(m_gpu)
    _, mean_c, se_c = image_stats(m_cpu)
    log(f"{label} 32 px / 4 spp, cuda vs cpu: {close:.4f} of pixels within rtol 1e-3 / atol 1e-4, "
        f"means {mean_g:.6f} vs {mean_c:.6f}")
    if close < 0.95 or abs(mean_g - mean_c) > tol_mean * abs(mean_c):
        raise SystemExit(f"chip_smoke: the small {label} cuda render disagrees with the cpu render")
    return m_cpu, se_c


def small_mesh_scene(width, spp):
    """A 5000-triangle wavy height field under a quad light (the cluster route at small size)."""
    from tpupt_torch.render.camera import Camera
    from tpupt_torch.scene.builder import Diffuse, Light, Scene

    n = 50
    x, z = np.meshgrid(np.linspace(-2, 2, n + 1), np.linspace(-2, 2, n + 1))
    pos = np.stack([x, 0.3 * np.sin(3 * x) * np.cos(2 * z), z], axis=-1).reshape(-1, 3)
    i = np.arange(n)[:, None] * (n + 1) + np.arange(n)[None, :]
    faces = np.stack([i, i + 1, i + n + 2, i, i + n + 2, i + n + 1], axis=-1).reshape(-1, 3)
    s = Scene()
    s.add_mesh(dict(positions=pos, normals=None, uvs=None, indices=faces), Diffuse((0.6, 0.5, 0.4)))
    s.add_quad((-1.0, 2.5, -1.0), (2.0, 0.0, 0.0), (0.0, 0.0, 2.0), Light((6.0, 6.0, 6.0)), light=True)
    s.environment = (0.1, 0.1, 0.2)
    cam = Camera(aspect_ratio=1.0, image_width=width, samples_per_pixel=spp, max_depth=6, vfov=50.0,
                 look_from=(0.0, 2.0, 4.0), look_at=(0.0, 0.0, 0.0), blur_strength=0.5,
                 focal_length=4.0, defocus_angle=0.0)
    return s, cam


def random_mesh_scene(width, spp, n=60_000, seed=2):
    """n random triangles in a blob (1344 clusters at 60000: the two-level route, K3) under
    a quad light, max_depth 6."""
    from tpupt_torch.render.camera import Camera
    from tpupt_torch.scene.builder import Diffuse, Light, Scene

    rng = np.random.default_rng(seed)
    pos = (rng.normal(size=(n, 1, 3)) * 1.5 + rng.normal(size=(n, 3, 3)) * 0.15).reshape(-1, 3)
    s = Scene()
    s.add_mesh(dict(positions=pos, normals=None, uvs=None, indices=np.arange(3 * n).reshape(n, 3)),
               Diffuse((0.6, 0.5, 0.4)))
    s.add_quad((-2.0, 5.0, -2.0), (4.0, 0.0, 0.0), (0.0, 0.0, 4.0), Light((6.0, 6.0, 6.0)), light=True)
    s.environment = (0.2, 0.25, 0.3)
    cam = Camera(aspect_ratio=1.0, image_width=width, samples_per_pixel=spp, max_depth=6, vfov=50.0,
                 look_from=(0.0, 1.0, 8.0), look_at=(0.0, 0.0, 0.0), blur_strength=0.5,
                 focal_length=8.0, defocus_angle=0.0)
    return s, cam


# ---------------------------------------------------------------------------
# gradients
# ---------------------------------------------------------------------------


def zero_counts():
    from tpupt_torch.ops import bvh_kernel, film_kernel, hit_kernel, loop_cond, tri_kernel, wavefront_kernel

    hit_kernel.launches = 0
    tri_kernel.launches.update(flat=0, two_level=0)
    bvh_kernel.launches = 0
    loop_cond.launches = loop_cond.gate_launches = loop_cond.countdown_launches = 0
    wavefront_kernel.launches.update(regen=0, shade=0)
    film_kernel.launches.update(add=0, resolve=0)


def read_counts():
    from tpupt_torch.ops import bvh_kernel, film_kernel, hit_kernel, loop_cond, tri_kernel, wavefront_kernel

    return {"K1": hit_kernel.launches, "K2": tri_kernel.launches["flat"],
            "K3": tri_kernel.launches["two_level"], "K4": bvh_kernel.launches, "K5": loop_cond.launches,
            "K5 gate": loop_cond.gate_launches, "K5 countdown": loop_cond.countdown_launches,
            "KW1": wavefront_kernel.launches["regen"], "KW2": wavefront_kernel.launches["shade"],
            "film add": film_kernel.launches["add"], "film resolve": film_kernel.launches["resolve"]}


def grad_box_scene(width, spp):
    """tests/test_grad.py's box (diffuse floor and sphere, a quad light overhead) under a
    grey sky, max_depth 12."""
    from tpupt_torch.render.camera import Camera
    from tpupt_torch.scene.builder import Diffuse, Light, Scene

    s = Scene()
    floor = Diffuse((0.73, 0.6, 0.5))
    s.add_quad((-4.0, 0.0, -4.0), (8.0, 0.0, 0.0), (0.0, 0.0, 8.0), floor)
    s.add_sphere(0.7, (0.0, 0.7, 0.0), floor)
    s.add_quad((-1.0, 3.0, -1.0), (2.0, 0.0, 0.0), (0.0, 0.0, 2.0), Light((6.0, 5.0, 4.0)), light=True)
    s.environment = (0.4, 0.5, 0.6)
    cam = Camera(aspect_ratio=1.0, image_width=width, samples_per_pixel=spp, max_depth=12, vfov=40.0,
                 look_from=(0.0, 1.0, 3.0), look_at=(0.0, 1.0, 0.0), blur_strength=0.5,
                 focal_length=3.0, defocus_angle=0.0)
    return s, cam


def grad_hdr_scene(width, spp):
    """tests/test_torch_grad_ref.py's HDR case: a principled sphere on a rough metal floor
    under a quad light and a seeded 16x8 HDR map (every material family's eval, both light
    members, the env_img gradient), max_depth 12."""
    from tpupt_torch.render.camera import Camera
    from tpupt_torch.scene.builder import ImageTexture, Light, Metal, Principled, Scene

    img = np.random.default_rng(0).uniform(0.05, 3.0, size=(8, 16, 3)).astype(np.float32)
    img[2, 5] = 60.0
    s = Scene()
    s.add_quad((-4.0, 0.0, -4.0), (8.0, 0.0, 0.0), (0.0, 0.0, 8.0), Metal((0.8, 0.7, 0.6), 0.3))
    s.add_sphere(0.7, (0.0, 0.7, 0.0), Principled((0.6, 0.5, 0.4), metallic=0.2, roughness=0.5, clearcoat=0.5,
                                                  sheen=0.3))
    s.add_quad((-1.0, 3.0, -1.0), (2.0, 0.0, 0.0), (0.0, 0.0, 2.0), Light((6.0, 5.0, 4.0)), light=True)
    s.environment = ImageTexture(img, hdr=True)
    cam = Camera(aspect_ratio=1.0, image_width=width, samples_per_pixel=spp, max_depth=12, vfov=40.0,
                 look_from=(0.0, 1.0, 3.0), look_at=(0.0, 1.0, 0.0), blur_strength=0.5,
                 focal_length=3.0, defocus_angle=0.0)
    return s, cam


def grads_call(compiled, cam, spp, replicas, route, seed=0):
    """One render_film_grads call by `route` ("graphs": the CUDA route; "eager": plain_grads),
    the counts zeroed just before and read just after -> (mean, grads, stats, numbers)."""
    from tpupt_torch.render.diff import plain_grads, render_film_grads

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    with plain_grads() if route == "eager" else contextlib.nullcontext():
        mean, grads, st = render_film_grads(compiled, cam, spp=spp, seed=seed, replicas=replicas,
                                            return_stats=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    out = dict(
        wall_s=wall, rays=st.rays, rays_per_s=st.rays / wall, trips=st.trips, lanes=st.lanes,
        forward_s=st.forward_s, backward_s=st.backward_s,
        forward_ms_per_trip=1e3 * st.forward_s / max(st.trips, 1),
        backward_ms_per_trip=1e3 * st.backward_s / max(st.trips, 1),
        capture_s=st.capture_s, host_reads=st.host_reads, chunks=st.chunks,
        peak_gib=torch.cuda.max_memory_allocated() / 2**30,
        launches_forward=st.launches_forward, launches_replay=st.launches_backward, counts=counts,
    )
    return mean, grads, st, out


def rel_l1(got, ref):
    """{field: sum|got - ref| / sum|ref|} (0 where both are 0, inf where only ref is)."""
    out = {}
    for k, r in ref.items():
        total, err = float(r.abs().sum()), float((got[k] - r).abs().sum())
        out[k] = err / total if total > 0 else (0.0 if err == 0 else math.inf)
    return out


def hold_routes(label, graphs, eager):
    """The graph route's (mean, grads, stats, numbers) against the eager route's: film bit-equal,
    rays and trips equal, gradients within GRAPH_REL_L1, each kernel once a trip forward and
    once in its replay, host reads = chunks + 1 -> (film bit-equal, relative L1 by field)."""
    (m_g, g_g, st_g, n_g), (m_e, g_e, st_e, _) = graphs, eager
    equal = bool(torch.equal(m_g.view(torch.int32), m_e.view(torch.int32)))
    errs = rel_l1(g_g, g_e)
    log(f"grads [{label}] graphs against the eager route: film bit-equal {equal}, rays {st_g.rays} / "
        f"{st_e.rays}, trips {st_g.trips} / {st_e.trips}; gradients' relative L1 by field {errs} (limit "
        f"{GRAPH_REL_L1}); host reads {st_g.host_reads} (chunks {st_g.chunks} + 1) against {st_e.host_reads}")
    if not equal or (st_g.rays, st_g.trips) != (st_e.rays, st_e.trips):
        diff = (m_g - m_e).abs()
        raise SystemExit(f"chip_smoke: the {label} gradient pass's film differs between the graphs and the eager "
                         f"route: {int((diff > 0).any(-1).sum())} pixels, rays {st_g.rays} vs {st_e.rays}, trips "
                         f"{st_g.trips} vs {st_e.trips}")
    if any(e > GRAPH_REL_L1 for e in errs.values()):
        raise SystemExit(f"chip_smoke: the {label} gradients differ between the graphs and the eager route: {errs}")
    for st in (st_g, st_e):
        used = [k for k, v in st.launches_forward.items() if v]
        if not used or any(st.launches_forward[k] != st.trips or st.launches_backward[k] != st.trips for k in used):
            raise SystemExit(f"chip_smoke: {label}: every kernel must launch once a trip forward and once in its "
                             f"replay: {st.launches_forward}, {st.launches_backward}, {st.trips} trips")
    conds = (n_g["counts"]["K5 gate"], n_g["counts"]["K5 countdown"])
    if st_g.host_reads != st_g.chunks + 1 or conds != (st_g.trips + st_g.chunks,) * 2:
        raise SystemExit(f"chip_smoke: {label}: host reads {st_g.host_reads}, chunks {st_g.chunks}, gate and "
                         f"countdown launches {conds}, trips {st_g.trips}: each must launch once a trip and a chunk")
    return equal, errs


def grads_run(label, compiled, cam, spp, replicas, reps):
    """render_film_grads by the graph route (its first call captures; then `reps` calls that
    replay) and by the eager route (a warm-up, then one timed call), each timed call with the
    counts zeroed just before and read just after; the graphs held against the eager route ->
    numbers of both routes (the graphs' last call)."""
    from tpupt_torch.render.diff import DIFF_FIELDS

    first = grads_call(compiled, cam, spp, replicas, "graphs")
    for rep in range(reps):
        graphs = grads_call(compiled, cam, spp, replicas, "graphs")
        if graphs[2].capture_s != 0.0:
            raise SystemExit(f"chip_smoke: the {label} gradient pass captured again on a call of the same shape")
    grads_call(compiled, cam, spp, replicas, "eager")  # warm-up
    eager = grads_call(compiled, cam, spp, replicas, "eager")
    for route, (mean, grads, st, n) in (("graphs, first call", first), ("graphs", graphs), ("eager", eager)):
        fin = float(torch.isfinite(mean).all(dim=-1).float().mean())
        finite = all(bool(torch.isfinite(grads[k]).all()) for k in DIFF_FIELDS)
        n.update(film_finite_share=fin, grads_finite=finite,
                 grad_abs_sum={k: float(grads[k].abs().sum()) for k in DIFF_FIELDS})
        log(f"grads [{label}] {route}: {cam.image_width}x{cam.image_height} {spp} spp max_depth {cam.max_depth}, "
            f"{st.lanes} lanes: {n['wall_s']:.4f} s, {st.rays} forward rays, {n['rays_per_s']:.4e} rays/s fwd+bwd, "
            f"{st.trips} trips, forward {st.forward_s:.4f} s ({n['forward_ms_per_trip']:.3f} ms a trip), backward "
            f"{st.backward_s:.4f} s ({n['backward_ms_per_trip']:.3f} ms a trip), capture {st.capture_s:.4f} s, "
            f"host reads {st.host_reads}, chunks {st.chunks}, peak memory {n['peak_gib']:.3f} GiB, launches "
            f"{n['counts']}, film finite share {fin:.6f}, gradients finite {finite}")
        if fin < 1.0 or not finite or mean.shape != (cam.image_height, cam.image_width, 3):
            raise SystemExit(f"chip_smoke: the {label} gradient run ({route}) is not finite: film {fin}")
        if not n["grad_abs_sum"]["mat_params"] > 0.0 or not n["grad_abs_sum"]["tex_rgb"] > 0.0:
            raise SystemExit(f"chip_smoke: the {label} gradients ({route}) are zero")
        if n["counts"]["K1"] != 2 * st.trips:
            raise SystemExit(f"chip_smoke: the {label} gradient run ({route}) launched K1 {n['counts']['K1']} "
                             f"times in {st.trips} trips")
    equal, errs = hold_routes(label, graphs, eager)
    g, e = graphs[3], eager[3]
    log(f"grads [{label}] graphs / eager: rays/s x{g['rays_per_s'] / e['rays_per_s']:.3f}, forward ms a trip "
        f"{g['forward_ms_per_trip']:.3f} / {e['forward_ms_per_trip']:.3f}, backward ms a trip "
        f"{g['backward_ms_per_trip']:.3f} / {e['backward_ms_per_trip']:.3f}, peak GiB {g['peak_gib']:.3f} / "
        f"{e['peak_gib']:.3f}; the first call {first[3]['wall_s']:.4f} s with {first[3]['capture_s']:.4f} s capture")
    return dict(graphs=g, graphs_first_call=first[3], eager=e, film_bit_equal=equal, rel_l1=errs,
                launches_forward=g["launches_forward"], launches_replay=g["launches_replay"])


def compare_grads(label, build, dev, kernel, bvh=None):
    """render_film_grads on the card, by the graphs and by the eager route, held against each
    other (hold_routes) and against the CPU (plain kernels): every gradient field within
    GRAD_REL_L1 (relative L1) and 95% of the image's pixels within rtol 1e-3 / atol 1e-4.
    bvh as in Scene.compile -> numbers."""
    from tpupt_torch.render.diff import render_film_grads

    scene, cam = build()
    m_cpu, g_cpu = render_film_grads(scene.compile(device="cpu", bvh=bvh), cam, seed=0)
    compiled = scene.compile(device=dev, bvh=bvh)
    spp = cam.samples_per_pixel
    graphs = grads_call(compiled, cam, spp, None, "graphs")
    eager = grads_call(compiled, cam, spp, None, "eager")
    equal, route_errs = hold_routes(label, graphs, eager)
    m_gpu, g_gpu, st, n = graphs
    close = float(np.isclose(m_gpu.cpu().numpy(), m_cpu.numpy(), rtol=1e-3, atol=1e-4).all(-1).mean())
    errs = rel_l1({k: v.cpu() for k, v in g_gpu.items()}, g_cpu)
    finite = all(bool(torch.isfinite(g).all()) for g in g_gpu.values())
    log(f"grads [{label}] {cam.image_width}x{cam.image_height} {spp} spp max_depth {cam.max_depth}, cuda (graphs) "
        f"vs cpu: {close:.4f} of pixels within rtol 1e-3 / atol 1e-4; relative L1 error by field {errs} (limit "
        f"{GRAD_REL_L1}); {kernel} launches {st.launches_forward[kernel]} forward + {st.launches_backward[kernel]} "
        f"in the replays ({st.trips} trips); capture {st.capture_s:.4f} s, host reads {st.host_reads}, chunks "
        f"{st.chunks}")
    if (n["counts"][kernel] != 2 * st.trips or st.launches_backward[kernel] != st.launches_forward[kernel]
            or st.launches_forward[kernel] != st.trips):
        raise SystemExit(f"chip_smoke: the {label} gradient run did not launch {kernel} in every trip")
    if close < 0.95 or not finite or any(e > GRAD_REL_L1 for e in errs.values()):
        raise SystemExit(f"chip_smoke: the {label} gradients on the card disagree with the cpu's")
    return dict(close=close, rel_l1=errs, film_bit_equal_to_eager=equal, rel_l1_to_eager=route_errs,
                launches_forward=st.launches_forward, launches_replay=st.launches_backward, trips=st.trips,
                graphs={k: n[k] for k in ("wall_s", "capture_s", "host_reads", "chunks", "peak_gib", "counts")},
                eager={k: eager[3][k] for k in ("wall_s", "host_reads", "peak_gib")})


def render_grads_call(compiled, cam, spp, route, seed=0):
    """One render_grads call of every pixel by `route` ("graphs": the CUDA route; "eager":
    plain_grads), the counts zeroed just before and read just after -> (radiance, grads,
    rays, numbers); the graphs' numbers (trips, chunks, host reads, capture) from the graphs
    the call kept on the compiled scene."""
    from tpupt_torch.render.diff import plain_grads, render_grads

    ids = np.arange(cam.image_width * cam.image_height, dtype=np.int32)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated() / 2**30
    zero_counts()
    t0 = time.perf_counter()
    with plain_grads() if route == "eager" else contextlib.nullcontext():
        radiance, grads, rays = render_grads(compiled, cam, ids, spp, seed=seed, return_stats=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    out = dict(wall_s=wall, rays=rays, rays_per_s=rays / wall, lanes=len(ids) * spp,
               peak_gib=torch.cuda.max_memory_allocated() / 2**30, held_gib=held, counts=read_counts())
    if route != "eager":
        (graphs,) = compiled.__dict__["_radiance_graphs"].values()
        out.update(trips=graphs.trips, chunks=graphs.chunks, host_reads=graphs.host_reads,
                   capture_s=graphs.capture_s)
    return radiance, grads, rays, out


def eager_radiance_reads(trips, max_depth, segment=8):
    """The eager masked scan's host reads, counted from its code (render/diff.py
    trace_radiance_scan): one a segment it tests (the first dead one too), one for the rays."""
    tested = trips // segment + 1 if trips < max_depth else -(-max_depth // segment)
    return tested + 1


def hold_radiance_routes(label, graphs, eager, max_depth):
    """render_grads by the graphs (radiance, grads, rays, numbers) against the eager route:
    radiance bit-equal, rays equal, gradients within GRAPH_REL_L1, every kernel launched as
    often by both routes, once a trip forward and once in its replay, K5's gate and
    countdown once a trip and a chunk, host reads = chunks + 1 -> (bit-equal, relative L1)."""
    (r_g, g_g, rays_g, n_g), (r_e, g_e, rays_e, n_e) = graphs, eager
    equal = bool(torch.equal(r_g.view(torch.int32), r_e.view(torch.int32))) and rays_g == rays_e
    errs = rel_l1(g_g, g_e)
    trips, chunks = n_g["trips"], n_g["chunks"]
    n_e["host_reads_counted"] = eager_radiance_reads(trips, max_depth)
    kernels = {k: (n_g["counts"][k], n_e["counts"][k]) for k in ("K1", "K2", "K3", "K4") if n_g["counts"][k]}
    log(f"render_grads [{label}] graphs against the eager route: radiance bit-equal and rays equal {equal} (rays "
        f"{rays_g} / {rays_e}); gradients' relative L1 by field {errs} (limit {GRAPH_REL_L1}); {trips} trips, "
        f"launches graphs / eager {kernels}, gate {n_g['counts']['K5 gate']}, countdown "
        f"{n_g['counts']['K5 countdown']}; host reads {n_g['host_reads']} (chunks {chunks} + 1) against the eager "
        f"route's {n_e['host_reads_counted']} (counted from its code)")
    if not equal:
        raise SystemExit(f"chip_smoke: render_grads [{label}] differs between the graphs and the eager route: "
                         f"{int((r_g != r_e).any(-1).sum())} pixels, rays {rays_g} vs {rays_e}")
    if any(e > GRAPH_REL_L1 for e in errs.values()):
        raise SystemExit(f"chip_smoke: render_grads [{label}] gradients differ between the routes: {errs}")
    if not kernels or any(a != b or a != 2 * trips for a, b in kernels.values()):
        raise SystemExit(f"chip_smoke: render_grads [{label}]: every kernel must launch once a trip forward and "
                         f"once in its replay by both routes: {kernels}, {trips} trips")
    conds = (n_g["counts"]["K5 gate"], n_g["counts"]["K5 countdown"])
    if n_g["host_reads"] != chunks + 1 or conds != (trips + chunks,) * 2:
        raise SystemExit(f"chip_smoke: render_grads [{label}]: host reads {n_g['host_reads']}, chunks {chunks}, "
                         f"gate and countdown {conds}, trips {trips}")
    return equal, errs


def render_grads_run(dev):
    """render_grads of the Cornell box at 600x600, 1 spp (360000 lanes, grads 600's count),
    max_depth 50, segments of 8: by the graphs (a first call that captures, then a replayed
    call at seed 1) and by the eager route at seed 1, held against each other -> numbers."""
    from tpupt_torch.render.diff import DIFF_FIELDS
    from tpupt_torch.scenes import cornell_box_scene

    scene, cam = cornell_box_scene(600, 1)
    compiled = scene.compile(device=dev)
    first = render_grads_call(compiled, cam, 1, "graphs", seed=0)
    graphs = render_grads_call(compiled, cam, 1, "graphs", seed=1)
    eager = render_grads_call(compiled, cam, 1, "eager", seed=1)
    if graphs[3]["capture_s"] != 0.0:
        raise SystemExit("chip_smoke: render_grads captured again on a second call of the same configuration")
    for route, (radiance, grads, rays, n) in (("graphs, first call", first), ("graphs, seed 1", graphs),
                                              ("eager, seed 1", eager)):
        fin = float(torch.isfinite(radiance).all(dim=-1).float().mean())
        finite = all(bool(torch.isfinite(grads[k]).all()) for k in DIFF_FIELDS)
        n.update(radiance_finite_share=fin, grads_finite=finite,
                 grad_abs_sum={k: float(grads[k].abs().sum()) for k in DIFF_FIELDS})
        log(f"render_grads [cornell 600] {route}: 600x600 1 spp max_depth {cam.max_depth}, {n['lanes']} lanes: "
            f"{n['wall_s']:.4f} s, {rays} forward rays, {n['rays_per_s']:.4e} rays/s fwd+bwd, trips "
            f"{n.get('trips', 'as the graphs')}, capture {n.get('capture_s', 0.0):.4f} s, host reads "
            f"{n.get('host_reads', 'see below')}, peak memory {n['peak_gib']:.3f} GiB ({n['held_gib']:.3f} held "
            f"before the call), launches {n['counts']}, "
            f"radiance finite share {fin:.6f}, gradients finite {finite}")
        if fin < 1.0 or not finite or radiance.shape != (360000, 3) or not n["grad_abs_sum"]["tex_rgb"] > 0.0:
            raise SystemExit(f"chip_smoke: render_grads [cornell 600] ({route}) is not finite or zero")
    equal, errs = hold_radiance_routes("cornell 600", graphs, eager, cam.max_depth)
    g, e = graphs[3], eager[3]
    log(f"render_grads [cornell 600] graphs / eager: fwd+bwd rays/s x{g['rays_per_s'] / e['rays_per_s']:.3f}, "
        f"wall {g['wall_s']:.4f} / {e['wall_s']:.4f} s, peak GiB {g['peak_gib']:.3f} / {e['peak_gib']:.3f}; the "
        f"first call {first[3]['wall_s']:.4f} s with {first[3]['capture_s']:.4f} s capture")
    return dict(graphs=g, graphs_first_call=first[3], eager=e, radiance_bit_equal=equal, rel_l1=errs)


def compare_render_grads(label, build, dev, kernel, bvh=None):
    """render_grads of every pixel on the card by the graphs and by the eager route, held
    against each other (hold_radiance_routes) and against the CPU (plain kernels): every
    gradient field within GRAD_REL_L1 (relative L1), 95% of radiances within rtol 1e-3 /
    atol 1e-4 -> numbers."""
    from tpupt_torch.render.diff import render_grads

    scene, cam = build()
    spp = cam.samples_per_pixel
    ids = np.arange(cam.image_width * cam.image_height, dtype=np.int32)
    r_cpu, g_cpu = render_grads(scene.compile(device="cpu", bvh=bvh), cam, ids, spp, seed=0)
    compiled = scene.compile(device=dev, bvh=bvh)
    graphs = render_grads_call(compiled, cam, spp, "graphs")
    eager = render_grads_call(compiled, cam, spp, "eager")
    equal, route_errs = hold_radiance_routes(label, graphs, eager, cam.max_depth)
    r_gpu, g_gpu, _, n = graphs
    close = float(np.isclose(r_gpu.cpu().numpy(), r_cpu.numpy(), rtol=1e-3, atol=1e-4).all(-1).mean())
    errs = rel_l1({k: v.cpu() for k, v in g_gpu.items()}, g_cpu)
    log(f"render_grads [{label}] {cam.image_width}x{cam.image_height} {spp} spp max_depth {cam.max_depth}, cuda "
        f"(graphs) vs cpu: {close:.4f} of radiances within rtol 1e-3 / atol 1e-4; relative L1 error by field {errs} "
        f"(limit {GRAD_REL_L1}); {kernel} launches {n['counts'][kernel]} ({n['trips']} trips)")
    if n["counts"][kernel] != 2 * n["trips"] or close < 0.95 or any(e > GRAD_REL_L1 for e in errs.values()):
        raise SystemExit(f"chip_smoke: render_grads [{label}] on the card disagrees with the cpu's or did not "
                         f"launch {kernel} in every trip")
    return dict(close=close, rel_l1=errs, radiance_bit_equal_to_eager=equal, rel_l1_to_eager=route_errs,
                trips=n["trips"], counts=n["counts"],
                graphs={k: n[k] for k in ("wall_s", "capture_s", "host_reads", "chunks", "peak_gib")},
                eager={k: eager[3][k] for k in ("wall_s", "host_reads_counted", "peak_gib")})


# ---------------------------------------------------------------------------
# image fixtures and the sharded phases
# ---------------------------------------------------------------------------


def check_image_fixtures(asset_dir, twin_dir):
    """The port's PNG and JPEG readers on the committed stand-ins and their twins, bit for
    bit against PIL's decode (the stand-ins' .npy), and on the 1024x512 progressive
    stand-in against the sha256 of PIL's decode; then the stand-ins go into asset_dir and
    the twins, under the stand-ins' names, into twin_dir -> decode ms by file."""
    import hashlib

    from tpupt_torch.io.image import load_image_rgb8

    times = {}
    for name, of in [(n, n) for n in FIXTURES] + list(TWINS.items()) + [(BIG_PROGRESSIVE, None)]:
        src = os.path.join(FIXTURE_DIR, name)
        t0 = time.perf_counter()
        got = load_image_rgb8(src)
        times[name] = 1e3 * (time.perf_counter() - t0)
        if of is None:  # held against the hash of PIL's decode
            with open(os.path.splitext(src)[0] + ".json") as f:
                ref = json.load(f)
            n_bad = int(list(got.shape) != ref["shape"] or hashlib.sha256(got.tobytes()).hexdigest() != ref["sha256"])
            against = "the sha256 of PIL's decode: " + ("differs" if n_bad else "equal")
        else:
            want = np.load(os.path.join(FIXTURE_DIR, os.path.splitext(of)[0] + ".npy"))
            n_bad = int((got != want).sum()) if got.shape == want.shape else -1
            against = f"{n_bad} samples differ from PIL's decode" + (f" of {of}" if of != name else "")
        log(f"decode {name} ({got.shape[1]}x{got.shape[0]}) with the port's reader: {times[name]:.1f} ms, "
            f"{against}")
        if n_bad:
            raise SystemExit(f"chip_smoke: the port's decode of {name} differs from PIL's")
    for name in FIXTURES:
        os.makedirs(os.path.dirname(os.path.join(asset_dir, name)), exist_ok=True)
        shutil.copy(os.path.join(FIXTURE_DIR, name), os.path.join(asset_dir, name))
    write_twin_assets(twin_dir)
    return times


def write_twin_assets(root):
    """The twins under the names the scenes read (earthmap.jpg, envmap.jpg, bricks/*.png)."""
    for twin, name in TWINS.items():
        dst = os.path.join(root, name)
        if not os.path.exists(dst):
            os.makedirs(os.path.dirname(dst), exist_ok=True)
            shutil.copy(os.path.join(FIXTURE_DIR, twin), dst)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def nccl_world_of_one(compiled, cam, m_ref, st_ref):
    """render_image(mesh=make_mesh(1)) in this process, a world of 1 over NCCL: bit-equal to
    the render without a mesh (m_ref, st_ref), rays equal."""
    import datetime

    import torch.distributed as dist

    from tpupt_torch.parallel.sharding import make_mesh
    from tpupt_torch.render.renderer import render_image

    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{free_port()}", world_size=1, rank=0,
                            timeout=datetime.timedelta(seconds=120))
    try:
        mesh = make_mesh(1, device="cuda:0")
        t0 = time.perf_counter()
        mesh.all_reduce(torch.zeros(1, device="cuda:0"))  # NCCL sets its communicator up at the first one
        torch.cuda.synchronize()
        setup = time.perf_counter() - t0
        zero_counts()
        t0 = time.perf_counter()
        _, mean, st = render_image(compiled, cam, seed=0, progress=False, mesh=mesh)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counts()
        grads = sharded_grads_routes(mesh)
    finally:
        dist.destroy_process_group()
    equal = np.array_equal(mean, m_ref, equal_nan=True) and st.rays == st_ref.rays
    log(f"sharded [nccl, world of 1] cornell {cam.image_width}x{cam.image_height} {cam.samples_per_pixel} spp "
        f"max_depth {cam.max_depth}: {wall:.3f} s (the communicator's set-up before it, {setup:.3f} s), "
        f"{st.paths_per_s:.4e} paths/s, {st.iterations} iterations, "
        f"K1 {launches['K1']} launches, capture {st.capture_s:.3f} s (the graphs kept from the render without a "
        f"mesh); bit-equal to the render without a mesh: {equal} (rays {st.rays} vs {st_ref.rays}); {card_line()}")
    if not equal or launches["K1"] == 0:
        raise SystemExit("chip_smoke: the NCCL world of 1 differs from the render without a mesh")
    return {"cornell": dict(wall_s=wall, paths_per_s=st.paths_per_s, rays=st.rays, iterations=st.iterations,
                            launches=launches, bit_equal=equal, communicator_setup_s=setup, capture_s=st.capture_s),
            "render_grads_sharded box": grads}


@contextlib.contextmanager
def counted_all_reduces():
    """Within the block, every Mesh.all_reduce is counted into the yielded list."""
    from tpupt_torch.parallel import sharding

    calls, reduce = [], sharding.Mesh.all_reduce

    def counted(self, tensor, async_op=False):
        calls.append(tensor.numel())
        return reduce(self, tensor, async_op=async_op)

    sharding.Mesh.all_reduce = counted
    try:
        yield calls
    finally:
        sharding.Mesh.all_reduce = reduce


def sharded_grads_routes(mesh):
    """render_grads_sharded of the box (16x16, 8 spp, max_depth 12) over `mesh`, by the graphs
    (a first call, then a replayed one) and by the eager route, the counts zeroed just before
    each and read just after: films bit-equal, gradients within GRAPH_REL_L1, one all-reduce
    a segment and one for the film on each route -> numbers."""
    from tpupt_torch.parallel.sharding import render_grads_sharded
    from tpupt_torch.render.diff import SEGMENT, plain_grads

    scene, cam = grad_box_scene(16, 8)
    compiled = scene.compile(device=mesh.device)
    ids = np.arange(256, dtype=np.int32)
    runs = {}
    for route in ("graphs", "graphs, replay", "eager"):
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        with counted_all_reduces() as calls, plain_grads() if route == "eager" else contextlib.nullcontext():
            film, grads = render_grads_sharded(compiled, cam, ids, ids // 16, ids % 16, spp=8, mesh=mesh)
        torch.cuda.synchronize()
        runs[route] = dict(film=film, grads=grads, wall_s=time.perf_counter() - t0, collectives=len(calls),
                           counts=read_counts())
    (graphs,) = compiled.data.__dict__["_radiance_graphs"].values()
    g, r, e = runs["graphs"], runs["graphs, replay"], runs["eager"]
    n_seg = -(-cam.max_depth // SEGMENT)
    equal = bool(torch.equal(g["film"].view(torch.int32), e["film"].view(torch.int32))
                 and torch.equal(r["film"], g["film"]))
    errs = {k: max(a, b) for (k, a), b in zip(rel_l1(g["grads"], e["grads"]).items(),
                                               rel_l1(r["grads"], e["grads"]).values())}
    log(f"sharded [world of {mesh.size}] render_grads_sharded (box 16x16, 8 spp) graphs against the eager route: film bit-equal {equal}, gradients' relative L1 {errs} (limit "
        f"{GRAPH_REL_L1}); all-reduces graphs / replay / eager {g['collectives']} / {r['collectives']} / "
        f"{e['collectives']} ({n_seg} segments + the film); wall {g['wall_s']:.4f} / {r['wall_s']:.4f} / "
        f"{e['wall_s']:.4f} s, the replay's capture {graphs.capture_s:.4f} s, K1 {r['counts']['K1']} launches "
        f"in {graphs.trips} trips")
    if (not equal or any(x > GRAPH_REL_L1 for x in errs.values()) or graphs.capture_s != 0.0
            or {g["collectives"], r["collectives"], e["collectives"]} != {n_seg + 1}
            or r["counts"]["K1"] != 2 * graphs.trips):
        raise SystemExit("chip_smoke: render_grads_sharded by the graphs differs from its eager route, captured "
                         "again, or issued another count of collectives")
    return dict(film_bit_equal=equal, rel_l1=errs, collectives=g["collectives"], trips=graphs.trips,
                launches=r["counts"], **{f"{route} wall_s": v["wall_s"] for route, v in runs.items()})


def sharded_worker(rank, world, store, out, device, width, spp):
    """A rank of the two-rank phase: gloo, every rank on `device` (cuda:0). Saves its
    results to out/rank<rank>.pt."""
    import torch.distributed as dist

    from tpupt_torch.parallel.multihost import initialize_distributed, make_pod_mesh, render_block_pod
    from tpupt_torch.parallel.sharding import make_mesh, render_block_sharded, render_grads_sharded
    from tpupt_torch.render.renderer import render_image
    from tpupt_torch.scenes import cornell_box_scene, everything_scene

    initialize_distributed(f"file://{store}", num_processes=world, process_id=rank, backend="gloo",
                           device=device)
    sync = torch.cuda.synchronize if torch.device(device).type == "cuda" else (lambda: None)
    try:
        mesh = make_mesh(world, device=device)
        res = {}
        for label, build_fn in (("cornell", cornell_box_scene), ("scene6", everything_scene)):
            scene, cam = build_fn(width, spp[label])
            compiled = scene.compile(device=device)
            mesh.barrier()
            zero_counts()
            sync()
            t0 = time.perf_counter()
            _, mean, st = render_image(compiled, cam, seed=0, progress=False, mesh=mesh)
            sync()
            res[label] = dict(wall_s=time.perf_counter() - t0, paths=st.paths, rays=st.rays,
                              iterations=st.iterations, launches=read_counts(), mean=mean)
        scene, cam = grad_box_scene(16, 8)
        ids = np.arange(256, dtype=np.int32)
        zero_counts()
        with counted_all_reduces() as calls:
            film, grads = render_grads_sharded(scene.compile(device=device), cam, ids, ids // 16, ids % 16,
                                               spp=8, mesh=mesh)
        res["grads"] = (film.cpu().numpy(), {k: v.cpu().numpy() for k, v in grads.items()})
        res["grads_collectives"] = (len(calls), read_counts())
        scene, cam = cornell_box_scene(width, 8)
        compiled = scene.compile(device=device)
        ids = np.arange(width * width, dtype=np.int32)
        flat, flat_rays = render_block_sharded(compiled, cam, ids, ids // width, ids % width, spp=8, mesh=mesh)
        pod = make_pod_mesh(1, 2, device=device)
        film, rays = render_block_pod(compiled, cam, ids, ids // width, ids % width, spp=8, mesh=pod)
        res["pod"] = dict(close=bool(torch.allclose(film, flat, rtol=1e-5, atol=1e-6)),
                          max_abs_diff=float((film - flat).abs().max()), rays=rays, flat_rays=flat_rays)
        torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def gloo_two_ranks(dev, m_cornell, st_cornell, kernel_ms, width=600):
    """Spawn two gloo ranks on the one card (sharded_worker), join each with its own
    timeout, and hold them against one rank: rays equal, the film within rtol 1e-5 /
    atol 1e-6; the gradients within rtol 2e-4 / atol 1e-5 (tests/test_sharding.py);
    the pod mesh equal to the flat one."""
    import torch.multiprocessing as mp

    from tpupt_torch.render.diff import render_grads
    from tpupt_torch.scenes import everything_scene

    scene, cam = everything_scene(width, SHARDED_SPP["scene6"])  # one rank, as the two ranks render it
    m_s6, st_s6, _ = render("scene 6 stand-in (one rank for the two-rank phase)", scene.compile(device=dev),
                            cam, ["K1", "K2"], kernel_ms, compare=False)
    one = {"cornell": (m_cornell, st_cornell), "scene6": (m_s6, st_s6)}
    scene, cam = grad_box_scene(16, 8)
    rad1, g1 = render_grads(scene.compile(device=dev), cam, np.arange(256, dtype=np.int32), spp=8, seed=0)

    device = "cuda:0" if dev.type == "cuda" else "cpu"
    out = tempfile.mkdtemp(prefix="tpupt_ranks_")
    try:
        ctx = mp.get_context("spawn")
        t0 = time.perf_counter()
        procs = [ctx.Process(target=sharded_worker, args=(r, 2, os.path.join(out, "store"), out, device, width,
                                                                dict(SHARDED_SPP)))
                 for r in range(2)]
        for p in procs:
            p.start()
        for r, p in enumerate(procs):
            p.join(SHARDED_JOIN_S)
            if p.is_alive():
                for q in procs:
                    q.kill()
                raise SystemExit(f"chip_smoke: sharded rank {r} did not finish in {SHARDED_JOIN_S} s")
            if p.exitcode != 0:
                raise SystemExit(f"chip_smoke: sharded rank {r} exited with {p.exitcode}")
        wall_all = time.perf_counter() - t0
        ranks = [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False) for r in range(2)]
    finally:
        shutil.rmtree(out, ignore_errors=True)

    card = card_line()
    summary = {}
    for label in ("cornell", "scene6"):
        m1, st1 = one[label]
        row = {}
        for r, res in enumerate(ranks):
            v = res[label]
            ok = v["rays"] == st1.rays and bool(np.allclose(v["mean"], m1, rtol=1e-5, atol=1e-6, equal_nan=True))
            diff = float(np.nanmax(np.abs(v["mean"] - m1)))
            log(f"sharded [gloo, 2 ranks on {device}] {label} {width} px {SHARDED_SPP[label]} spp, rank {r}: "
                f"{v['wall_s']:.3f} s, {v['paths'] / v['wall_s']:.4e} paths/s, {v['iterations']} iterations "
                f"(one rank: {st1.iterations} in {st1.wall_s:.3f} s, {st1.paths_per_s:.4e} paths/s), launches "
                f"{v['launches']}; rays {v['rays']} vs {st1.rays}, max |film diff| {diff:.3e}: within rtol 1e-5 / "
                f"atol 1e-6 {ok}; {card}")
            if not ok:
                raise SystemExit(f"chip_smoke: the two-rank {label} render differs from one rank")
            if dev.type == "cuda" and any(v["launches"][k] == 0 for k in ("K1",) + (("K2",) if label == "scene6" else ())):
                raise SystemExit(f"chip_smoke: rank {r}'s {label} render did not launch its kernels")
            row[f"rank {r}"] = dict(wall_s=v["wall_s"], paths_per_s=v["paths"] / v["wall_s"],
                                    iterations=v["iterations"], launches=v["launches"], max_abs_diff=diff)
        row["one rank"] = dict(wall_s=st1.wall_s, paths_per_s=st1.paths_per_s, iterations=st1.iterations)
        summary[label] = row
    errs = []
    n_seg = -(-cam.max_depth // 8)
    for r, res in enumerate(ranks):
        n_calls, counts = res["grads_collectives"]
        if n_calls != n_seg + 1 or counts["K5 countdown"] == 0:
            raise SystemExit(f"chip_smoke: two-rank render_grads_sharded, rank {r}: {n_calls} all-reduces (want "
                             f"{n_seg} segments + the film), launches {counts}: not the graph route")
        film, grads = res["grads"]
        errs.append(float(np.abs(film - rad1.cpu().numpy()).max()))
        for k, ref in g1.items():
            if not np.allclose(grads[k], ref.cpu().numpy(), rtol=2e-4, atol=1e-5):
                raise SystemExit(f"chip_smoke: two-rank {k} gradients differ from one device's")
        if not np.allclose(film, rad1.cpu().numpy(), rtol=1e-4, atol=1e-5):
            raise SystemExit("chip_smoke: the two-rank gradient film differs from one device's")
    pods = [res["pod"] for res in ranks]
    log(f"sharded [gloo, 2 ranks] render_grads_sharded (box 16x16, 8 spp) vs render_grads: every field within "
        f"rtol 2e-4 / atol 1e-5, film max |diff| {max(errs):.3e}; pod mesh (1 host x 2 chips) vs flat mesh of 2 "
        f"(cornell {width}x{width}, 8 spp): {pods}; the phase {wall_all:.1f} s with the ranks' start-up")
    if not all(p["close"] and p["rays"] == p["flat_rays"] for p in pods):
        raise SystemExit("chip_smoke: the pod mesh differs from the flat mesh")
    summary["grads box"] = dict(film_max_abs_diff=max(errs), **{
        f"rank {r}": dict(collectives=res["grads_collectives"][0], launches=res["grads_collectives"][1])
        for r, res in enumerate(ranks)})
    summary["pod vs flat"] = pods
    summary["phase_wall_s"] = wall_all
    return {"gloo, 2 ranks on cuda:0": summary}


def dry_run():
    """tpupt_torch.entry.dryrun_multichip over every visible card, a rank a card over NCCL (a
    world of 1 on one card): its four checks pass in every rank, and K1 launches there."""
    from tpupt_torch.entry import dryrun_multichip

    n = torch.cuda.device_count()
    t0 = time.perf_counter()
    ranks = dryrun_multichip(n)
    wall = time.perf_counter() - t0
    card = card_line()
    for r in ranks:
        log(f"dryrun_multichip({n}) [nccl] rank {r['rank']} on {r['device']}: render_image(mesh) vs one "
            f"device {r['render_image']}, render_block_sharded {r['render_block_sharded']}, pod mesh "
            f"{r.get('render_block_pod', 'not run (odd world)')}, render_grads_sharded "
            f"{r['render_grads_sharded']}, K1 {r['K1_launches']} launches; the call {wall:.1f} s with the "
            f"ranks' start-up; {card}")
        if r["K1_launches"] == 0:
            raise SystemExit(f"chip_smoke: dryrun_multichip's rank {r['rank']} never launched K1")
    return {f"dryrun_multichip, nccl world of {n}": {
        "cornell 16 px": {"rank 0": dict(ranks[0], launches={"K1": ranks[0]["K1_launches"]})},
        "wall_s": wall}}


def entry_on_the_card():
    """tpupt_torch.entry.entry() on the card: the radiance of 4096 Cornell lanes -> K1 launches."""
    from tpupt_torch.entry import entry

    fn, args = entry()
    zero_counts()
    t0 = time.perf_counter()
    radiance = fn(*args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k1 = read_counts()["K1"]
    ok = radiance.shape == (4096, 3) and radiance.is_cuda and bool(torch.isfinite(radiance).all())
    log(f"entry() on {radiance.device}: radiance {tuple(radiance.shape)}, finite {ok}, mean "
        f"{float(radiance.mean()):.6f}, {wall:.3f} s, K1 {k1} launches")
    if not ok or k1 == 0 or not float(radiance.mean()) > 0.0:
        raise SystemExit("chip_smoke: entry() on the card is wrong or never launched K1")
    return k1


@contextlib.contextmanager
def assets_in(path):
    """TPUPT_ASSETS pointed at `path` inside the block (a scene resolves its files when
    it is built)."""
    old = os.environ["TPUPT_ASSETS"]
    os.environ["TPUPT_ASSETS"] = path
    try:
        yield
    finally:
        os.environ["TPUPT_ASSETS"] = old


# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", type=str, default=None, metavar="DIR")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    try:
        from tpupt_torch import build, native
        from tpupt_torch.ops import hit_kernel
        from tpupt_torch.render.renderer import render_image
        from tpupt_torch.scenes import balls_scene, cornell_box_scene, everything_scene
    except ImportError as e:
        print(f"chip_smoke: run from a checkout of the repository ({e})", file=sys.stderr)
        return 1

    dev = torch.device("cuda")
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    t_start = time.perf_counter()

    # ---- build every library of the port, one compiler per source, all at once ----
    t0 = time.perf_counter()
    reports = build.build_all(["hit_kernel", "tri_kernel", "bvh_kernel", "loop_cond", "wavefront", "film",
                               "native_host"])
    log(f"build (nvcc x6, g++ x1, in parallel): {time.perf_counter() - t0:.2f} s")
    for name, rep in reports.items():
        for line in rep.splitlines():
            if any(w in line for w in ("registers", "smem", "spill")):
                log(f"  {name}: {line.strip()}")
    log(f"host builder (OBJ parse, SAH build): {native.builder()}")
    if not native.available():  # the numpy fallback would hide a failed g++ build
        print("chip_smoke: the compiled host library is not in use", file=sys.stderr)
        return 1

    asset_dir = tempfile.mkdtemp(prefix="tpupt_assets_")
    env_dir = tempfile.mkdtemp(prefix="tpupt_env_")
    twin_dir = tempfile.mkdtemp(prefix="tpupt_twins_")
    try:
        os.environ["TPUPT_ASSETS"] = asset_dir
        tris = write_stand_in_assets(asset_dir)
        write_hdr_env_assets(env_dir)
        decode_ms = check_image_fixtures(asset_dir, twin_dir)
        log(f"stand-in assets (synthetic, not the reference's files) in TPUPT_ASSETS: "
            f"{tris} triangles, grace_probe_latlong.hdr 128x64; for the environment-map scene "
            f"grace_probe_latlong.hdr {HDR_ENV_WH[0]}x{HDR_ENV_WH[1]}")
        kernels, grads, sharded = run(args, dev, hit_kernel, render_image, cornell_box_scene,
                                      balls_scene, everything_scene, env_dir, twin_dir)
    finally:
        for d in (asset_dir, env_dir, twin_dir):
            shutil.rmtree(d, ignore_errors=True)

    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"decode_ms": decode_ms, "card": card}))
    log(json.dumps({"grads": grads, "profile": GRAD_PROFILE or None, "card": card}))
    log(json.dumps({"sharded": sharded, "card": card}))
    log(json.dumps({"routes": ROUTES, "card": card}))
    log(json.dumps({"render_grads": RENDER_GRADS, "card": card}))
    if args.profile:
        log(json.dumps({"profiles": PROFILES, "card": card}))
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


def run(args, dev, hit_kernel, render_image, cornell_box_scene, balls_scene, everything_scene, env_dir,
        twin_dir):
    from tpupt_torch.scenes import SCENES, environment_map_scene

    def env_build(width, spp):
        with assets_in(env_dir):
            return environment_map_scene(width, spp, hdr_env=True)

    # ---- the scenes (host set-up: OBJ parse, SAH build, packing, the env's alias table) ----
    phase("scene set-up")
    t0 = time.perf_counter()
    cscene, ccam = cornell_box_scene(600, SPP["cornell"])
    c_compiled = cscene.compile(device=dev)
    s6scene, s6cam = everything_scene(600, SPP["scene6"])
    s6 = s6scene.compile(device=dev)
    bscene, bcam = bigmesh_scene(600, SPP["bigmesh"])
    big = bscene.compile(device=dev)
    escene, ecam = env_build(600, SPP["env"])
    env = escene.compile(device=dev)
    if not (env.data.env_is_hdr and env.has_lights and env.data.env_wh_host == HDR_ENV_WH):
        raise SystemExit("chip_smoke: the environment-map scene did not compile to an HDR env")
    log(f"scene set-up {time.perf_counter() - t0:.2f} s: environment map {env.data.env_wh_host} texels, "
        f"{env.data.env_sam.shape[0]} alias rows; scene 6 stand-in {s6.data.n_tris} triangle "
        f"rows, {s6.data.tri_cl.shape[0]} clusters, flat route {s6.data.has_tri_clusters}; bigmesh "
        f"{big.data.n_tris} triangle rows, {big.data.tri_cl.shape[0]} clusters, two-level route "
        f"{big.data.has_tri_clusters_hbm} (superclusters of {big.data.tri_sc_size})")
    if not (s6.data.has_tri_clusters and big.data.has_tri_clusters_hbm):
        raise SystemExit("chip_smoke: the mesh scenes did not route to the flat and two-level kernels")
    t0 = time.perf_counter()
    s6b = s6scene.compile(device=dev, bvh=True)  # the stackless BVH (K4), cluster tables kept
    bigb = bscene.compile(device=dev, bvh=True)
    log(f"scene set-up with bvh=True {time.perf_counter() - t0:.2f} s: scene 6 stand-in "
        f"{s6b.data.bvh_skip.shape[0]} nodes, bigmesh {bigb.data.bvh_skip.shape[0]} nodes")
    if not (s6b.data.has_tri_bvh and bigb.data.has_tri_bvh):
        raise SystemExit("chip_smoke: bvh=True did not route the mesh scenes to the stackless BVH")
    bvh_shapes = {"scene6": (s6b, s6cam), "bigmesh": (bigb, bcam)}

    # ---- every kernel against its plain version on the card ----
    phase("kernels against their plain versions")
    balls_scene_, balls_cam = balls_scene(600, SPP["balls"])
    balls = balls_scene_.compile(device=dev)
    k1_shapes = {  # K1's four table shapes: (compiled scene, camera, box of the random rays)
        "cornell": (c_compiled, ccam, (0.0, 555.0)),
        "scene6": (s6, s6cam, (-12.0, 12.0)),
        "balls": (balls, balls_cam, (-12.0, 12.0)),
        "env": (env, ecam, (-20.0, 20.0)),
    }
    bad = {"K1": 0, "K2": 0, "K3": 0, "K4": 0}
    err = {"K1": 0.0, "K2": 0.0, "K3": 0.0, "K4": 0.0}
    k1_rays = {}
    for seed, (shape, (compiled, cam, (lo, hi))) in enumerate(k1_shapes.items()):
        sph, quad = hit_kernel.tables(compiled.data)
        k1_rays[shape] = k1_batches(hit_kernel, compiled.data, cam, dev, seed + 20)
        for label, rays in (("random", random_rays(1 << 20, seed + 1, lo, hi, dev)),
                            *k1_rays[shape].items()):
            n, e = check_k1(hit_kernel, sph, quad, rays, f"{shape}, {label}")
            bad["K1"] += n
            err["K1"] = max(err["K1"], e)
    tri_batches = {}
    for name, sd, cam, seed in (("K2", s6.data, s6cam, 3), ("K3", big.data, bcam, 4)):
        o, d, t = camera_rays(cam, dev)
        camera = (o, d, torch.full_like(t, 3e38))
        kt, _, ka = tri_args(sd)[0](*camera)
        tri_batches[name] = {"camera": camera, "bounce": bounce_rays(o, d, kt, ka["ns_raw"], seed + 10)}
        for label, rays in (
            (f"{name} random", tri_test_rays(sd, 1 << 20, seed, dev)),
            (f"{name} camera", camera),
            (f"{name} bounce", tri_batches[name]["bounce"]),
        ):
            n, e = check_tri(name, sd, rays, label)
            bad[name] += n
            err[name] = max(err[name], e)
    k4_rays = {}
    for seed, (shape, (compiled, cam)) in enumerate(bvh_shapes.items()):
        k4_rays[shape] = bvh_batches(compiled.data, cam, dev, seed + 30)
        for label, rays in (("random", tri_test_rays(compiled.data, 1 << 20, seed + 5, dev)),
                            *k4_rays[shape].items(),
                            ("camera, half dead, NaN rays", masked_rays(k4_rays[shape]["camera"]))):
            n, e = check_bvh(compiled.data, rays, f"{shape}, {label}")
            bad["K4"] += n
            err["K4"] = max(err["K4"], e)
    bad["K5"], err["K5"], k5_timing = check_stage_cond(dev)
    grad_bad, grad_err, grad_timing = check_grad_conds(dev)
    for mode in ("gate", "countdown"):
        bad[f"K5 {mode}"], err[f"K5 {mode}"] = grad_bad[mode], grad_err[mode]
    wf_runner, wf_states = wavefront_states(c_compiled, ccam, dev)
    wf_bad, wf_err = check_wavefront(wf_runner, wf_states)
    bad.update(wf_bad)
    err.update(wf_err)
    film_bad, film_compared = check_film(dev)
    bad.update(film_bad)
    err.update({k: 0.0 for k in film_bad})  # held bit for bit
    if any(bad.values()):
        raise SystemExit(f"chip_smoke: kernels disagree with their plain versions: {bad}")

    # ---- timings at the main path's lane counts ----
    phase("kernel timings")
    k1_times = {}
    for shape, (compiled, _, _) in k1_shapes.items():
        sph, quad = hit_kernel.tables(compiled.data)
        k1_times[shape] = {batch: time_k1(hit_kernel, shape, batch, sph, quad, rays)
                           for batch, rays in k1_rays[shape].items()}
    k1 = k1_times["cornell"]["camera"]
    timing = {"K1": (k1["ms"], k1["plain_ms"], k1["bound_ms"], k1["bound_by"])}
    bounce = {}
    for name, sd in (("K2", s6.data), ("K3", big.data)):
        timing[name] = time_tri(name, sd, "camera", tri_batches[name]["camera"])
        bounce[name] = time_tri(name, sd, "bounce", tri_batches[name]["bounce"])
    # K4, and K2 (scene 6) and K3 (bigmesh) from the same SceneData with the flags flipped,
    # on K4's batches (the bounce rays' dead lanes: a seed of 0 for all three)
    k4_times, same_rays = {}, {}
    for shape, (compiled, _) in bvh_shapes.items():
        k4_times[shape] = {batch: time_bvh(shape, batch, compiled.data, rays)
                           for batch, rays in k4_rays[shape].items()}
        name = "K2" if shape == "scene6" else "K3"
        clusters = routes(compiled.data)["clusters"]
        same_rays[shape] = {batch: dict(zip(("kernel", "ms", "plain_ms", "bound_ms", "bound_by"),
                                            (name, *time_tri(name, clusters, f"{batch}, K4's batch", rays))))
                            for batch, rays in k4_rays[shape].items()}
    k4 = k4_times["scene6"]["camera"]
    timing["K4"] = (k4["ms"], k4["plain_ms"], k4["bound_ms"], k4["bound_by"])
    b4 = k4_times["scene6"]["bounce"]
    bounce["K4"] = (b4["ms"], b4["plain_ms"], b4["bound_ms"], b4["bound_by"])
    mxu = check_mxu(s6b.data, k4_rays["scene6"]["camera"], same_rays["scene6"]["camera"]["ms"])
    timing["K5"] = k5_timing
    timing["K5 gate"], timing["K5 countdown"] = grad_timing["gate"], grad_timing["countdown"]
    # KW1, KW2 at stage 0 (ms, the plain route's whole iteration, the bytes bound), and at the
    # last stage beside it
    wf_times = time_wavefront(wf_runner, wf_states)
    wf0, wf_tail = (wf_times[label] for label in wf_states)
    del wf_runner, wf_states
    for k in ("KW1", "KW2"):
        timing[k] = (wf0[k]["ms"], wf0["plain_iteration_ms"], wf0[k]["bound_ms"], "bytes")
    film_times = time_film(dev)
    for k in ("film add", "film resolve"):
        f = film_times["cornell"][k]
        timing[k] = (f["ms"], f["plain_ms"], f["bound_ms"], "bytes")
    kernel_ms = {k: v[0] for k, v in timing.items()}

    # ---- the main path: the renders through render_image, each by both routes ----
    phase("renders, graphs and eager loop")
    m_cornell, st_cornell, cl = render("cornell", c_compiled, ccam, ["K1"], kernel_ms)
    _, _, s6l = render("scene 6 stand-in", s6, s6cam, ["K1", "K2"],
                       dict(kernel_ms, K1=k1_times["scene6"]["camera"]["ms"]))
    _, _, bl = render("bigmesh stand-in", big, bcam, ["K3"], kernel_ms)
    _, _, ball = render("balls", balls, balls_cam, ["K1"], dict(kernel_ms, K1=k1_times["balls"]["camera"]["ms"]))
    m_env, _, el = render("environment map (HDR, importance sampled)", env, ecam, ["K1"],
                          dict(kernel_ms, K1=k1_times["env"]["camera"]["ms"]))
    # scenes 2, 5 and 7: their textures through the port's PNG and JPEG readers, from the
    # baseline stand-ins and then from their twins (progressive JPEG, 16-bit and Adam7 PNG),
    # which decode to the same bytes: the two renders must be bit-equal
    textured, textured_k5, textured_kw = {}, {}, {}
    for sid in (2, 5, 7):
        name, build_fn = SCENES[sid]
        films = []
        for what, root in (("stand-in textures", os.environ["TPUPT_ASSETS"]), ("twins", twin_dir)):
            with assets_in(root):
                scene, cam = build_fn(600, SPP["textures"])
                compiled = scene.compile(device=dev)
            if not compiled.data.has_image_textures or (sid == 7) != compiled.data.has_normal_maps:
                raise SystemExit(f"chip_smoke: scene {sid} did not compile its image textures")
            mean, st, tl = render(f"scene {sid} ({name}, {what})", compiled, cam, ["K1"], kernel_ms,
                                  compare=what != "twins")
            textured[f"scene{sid}" + (" twins" if what == "twins" else "")] = tl["K1"]
            textured_k5[f"scene{sid}" + (" twins" if what == "twins" else "")] = tl["K5"]
            textured_kw[f"scene{sid}" + (" twins" if what == "twins" else "")] = tl
            films.append((mean, st.rays))
        (m_a, rays_a), (m_b, rays_b) = films
        equal = np.array_equal(m_a, m_b, equal_nan=True) and rays_a == rays_b
        log(f"scene {sid} from the twins vs the stand-ins: film bit-equal and rays equal {equal} "
            f"(rays {rays_b} vs {rays_a})")
        if not equal:
            raise SystemExit(f"chip_smoke: scene {sid} renders differently from the twins of its textures")
    # the stackless BVH through render_image: K4 once an iteration
    _, _, s6bl = render("scene 6 stand-in, bvh=True", s6b, s6cam, ["K1", "K4"],
                        dict(kernel_ms, K1=k1_times["scene6"]["camera"]["ms"]))
    _, _, bbl = render("bigmesh stand-in, bvh=True", bigb, bcam, ["K4"],
                       dict(kernel_ms, K4=k4_times["bigmesh"]["camera"]["ms"]))
    launches = {"K1": cl["K1"], "K2": s6l["K2"], "K3": bl["K3"], "K4": s6bl["K4"], "K5": cl["K5"], "KW1": cl["KW1"],
                "KW2": cl["KW2"], "film add": cl["film add"], "film resolve": cl["film resolve"]}
    render_counts = {"cornell": cl, "scene6": s6l, "bigmesh": bl, "balls": ball, "env": el, **textured_kw,
                     "scene6 bvh": s6bl, "bigmesh bvh": bbl}
    k1_launches = {"cornell": cl["K1"], "scene6": s6l["K1"], "balls": ball["K1"], "env": el["K1"]}
    for shape, n in k1_launches.items():  # which shape K1's time above its bound costs the most
        over = {batch: n * (v["ms"] - v["bound_ms"]) for batch, v in k1_times[shape].items()}
        log(f"K1 [{shape}]: {n} launches x (ms - bound) = {over['camera']:.3f} ms on camera rays, "
            f"{over['bounce']:.3f} ms on bounce rays")

    # ---- small renders on the card against the same renders on the cpu ----
    phase("small renders, card against cpu")
    m_cpu, se_c = compare_small("cornell", cornell_box_scene, dev)
    compare_small("mesh (5000 triangles, flat cluster route)", small_mesh_scene, dev)
    compare_small("mesh (5000 triangles, BVH route)", small_mesh_scene, dev, bvh=True)
    fin_g, mean_g, se_g = image_stats(m_cornell)
    fin_c, mean_c, _ = image_stats(m_cpu)
    tol = 5.0 * math.sqrt(se_g * se_g + se_c * se_c)
    log(f"cornell 600 px cuda vs 32 px cpu: finite share {fin_g:.6f} vs {fin_c:.6f}, mean radiance "
        f"{mean_g:.6f} vs {mean_c:.6f} (|diff| {abs(mean_g - mean_c):.6f}, 5-sigma tol {tol:.6f})")
    if abs(fin_g - fin_c) > 0.01 or abs(mean_g - mean_c) > tol:
        raise SystemExit("chip_smoke: the cornell film differs from the cpu render")
    for sid in (2, 5, 7):
        compare_small(f"scene {sid} ({SCENES[sid][0]}, stand-in textures)", SCENES[sid][1], dev)
    m_env_cpu, se_ec = compare_small("environment map (HDR, importance sampled)", env_build, dev)
    fin_g, mean_g, se_g = image_stats(m_env)
    fin_c, mean_c, _ = image_stats(m_env_cpu)
    tol = 5.0 * math.sqrt(se_g * se_g + se_ec * se_ec)
    log(f"environment map 600 px cuda vs 32 px cpu: finite share {fin_g:.6f} vs {fin_c:.6f}, mean "
        f"radiance {mean_g:.6f} vs {mean_c:.6f} (|diff| {abs(mean_g - mean_c):.6f}, 5-sigma tol {tol:.6f})")
    if fin_g < 1.0 or abs(mean_g - mean_c) > tol:
        raise SystemExit("chip_smoke: the environment-map film differs from the cpu render")

    # ---- gradients: render_film_grads as graphs (the forward trips and their replays looping on
    # the card, K5's gate and countdown) and by the eager route, its plain version ----
    phase("gradients, graphs and eager route")
    grads = {}
    for i, (label, cfg) in enumerate(GRADS.items()):
        gscene, gcam = cornell_box_scene(cfg["width"], cfg["spp"])
        grads[label] = grads_run(label, gscene.compile(device=dev), gcam, cfg["spp"], cfg["replicas"],
                                 reps=2 if i == 0 else 1)
    grads["box, cuda vs cpu"] = compare_grads("box", lambda: grad_box_scene(16, 8), dev, "K1")
    grads["hdr env, cuda vs cpu"] = compare_grads("hdr env (principled, metal, HDR map)",
                                                  lambda: grad_hdr_scene(16, 8), dev, "K1")
    grads["mesh, cuda vs cpu"] = compare_grads("mesh (5000 triangles, flat cluster route)",
                                               lambda: small_mesh_scene(16, 8), dev, "K2")
    grads["two-level mesh, cuda vs cpu"] = compare_grads(
        "mesh (60000 random triangles, two-level cluster route)", lambda: random_mesh_scene(16, 8), dev, "K3")
    grads["bvh mesh, cuda vs cpu"] = compare_grads(
        "mesh (5000 triangles, BVH route)", lambda: small_mesh_scene(16, 8), dev, "K4", bvh=True)

    # ---- render_grads: the masked scan and its replays as graphs, and by the eager route ----
    phase("render_grads, graphs and eager route")
    RENDER_GRADS["cornell 600"] = render_grads_run(dev)
    RENDER_GRADS["box, cuda vs cpu"] = compare_render_grads("box", lambda: grad_box_scene(16, 8), dev, "K1")
    RENDER_GRADS["mesh, cuda vs cpu"] = compare_render_grads(
        "mesh (5000 triangles, flat cluster route)", lambda: small_mesh_scene(16, 8), dev, "K2")
    RENDER_GRADS["two-level mesh, cuda vs cpu"] = compare_render_grads(
        "mesh (60000 random triangles, two-level cluster route)", lambda: random_mesh_scene(16, 8), dev, "K3")
    RENDER_GRADS["bvh mesh, cuda vs cpu"] = compare_render_grads(
        "mesh (5000 triangles, BVH route)", lambda: small_mesh_scene(16, 8), dev, "K4", bvh=True)

    # ---- the sharded phases: a world of 1 over NCCL, then two gloo ranks on the one card ----
    phase("sharded phases")
    sharded = {"nccl, world of 1": nccl_world_of_one(c_compiled, ccam, m_cornell, st_cornell)}
    sharded.update(gloo_two_ranks(dev, m_cornell, st_cornell, kernel_ms))
    phase("dry run and entry()")
    sharded.update(dry_run())
    entry_k1 = entry_on_the_card()

    if args.profile:
        phase("profiles")
        for label, build, bvh in (("cornell", cornell_box_scene, None), ("scene6", everything_scene, None),
                                  ("bigmesh", bigmesh_scene, None), ("balls", balls_scene, None),
                                  ("env", env_build, None),
                                  *((f"scene{sid}", SCENES[sid][1], None) for sid in (2, 5, 7)),
                                  ("scene6_bvh", everything_scene, True), ("bigmesh_bvh", bigmesh_scene, True)):
            scene, cam = build(600, 2)
            profile_render(args.profile, label, render_image, scene.compile(device=dev, bvh=bvh), cam)
        cfg = GRADS["grads"]
        scene, cam = cornell_box_scene(cfg["width"], cfg["spp"])
        profile_grads(args.profile, scene.compile(device=dev), cam, cfg["spp"], cfg["replicas"])

    meta = {
        "K1": ("K1 closest_sphere_quad", "tpupt_torch/csrc/hit_kernel.cu", "tpupt/ops/pallas_hit.py:35"),
        "K2": ("K2 closest_tri_flat", "tpupt_torch/csrc/tri_kernel.cu", "tpupt/ops/pallas_tri.py:300"),
        "K3": ("K3 closest_tri_two_level", "tpupt_torch/csrc/tri_kernel.cu", "tpupt/ops/pallas_tri.py:632"),
        "K4": ("K4 closest_tri_bvh", "tpupt_torch/csrc/bvh_kernel.cu", "tpupt/ops/bvh.py:362"),
        "K5": ("K5 stage_cond", "tpupt_torch/csrc/loop_cond.cu", "tpupt/render/integrator.py:306"),
        "K5 gate": ("K5 grad_gate", "tpupt_torch/csrc/loop_cond.cu", "tpupt/render/diff.py:244"),
        "K5 countdown": ("K5 grad_countdown", "tpupt_torch/csrc/loop_cond.cu", "tpupt/render/diff.py:246"),
        # no Pallas kernel: XLA fuses the reference's jitted iteration by itself
        "KW1": ("KW1 regen_kernel", "tpupt_torch/csrc/wavefront.cu", "tpupt/render/integrator.py:306-322"),
        "KW2": ("KW2 shade_kernel", "tpupt_torch/csrc/wavefront.cu", "tpupt/render/integrator.py:306-322"),
        # no Pallas kernel: the reference adds and resolves its film in numpy on the host
        "film add": ("film_add_kernel", "tpupt_torch/csrc/film.cu", "tpupt/render/renderer.py:346"),
        "film resolve": ("film_resolve_kernel", "tpupt_torch/csrc/film.cu", "tpupt/render/renderer.py:372-374"),
    }
    # the gradient modes' launches: the `grads` pass by the graphs (a replayed call)
    for mode in ("K5 gate", "K5 countdown"):
        launches[mode] = grads["grads"]["graphs"]["counts"][mode]
    kernels = []
    for k, (name, source, replaces) in meta.items():
        ms, plain_ms, bound_ms, bound_by = timing[k]
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces, launches=launches[k],
            max_abs_err=err[k], ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
            library_ms=None, status=f"ported, launches {launches[k]}, mismatches {bad[k]}",
        ))
        if k in bounce:  # the same kernel on the rays that follow the camera rays' hits
            b_ms, b_plain, b_bound, _ = bounce[k]
            kernels[-1].update(ms_bounce=b_ms, plain_ms_bounce=b_plain, bound_ms_bounce=b_bound)
        if k == "K1":  # Cornell's bounce batch, and every table shape with its launches
            b = k1_times["cornell"]["bounce"]
            kernels[-1].update(ms_bounce=b["ms"], plain_ms_bounce=b["plain_ms"],
                               bound_ms_bounce=b["bound_ms"],
                               shapes={shape: dict(v, launches=k1_launches[shape])
                                       for shape, v in k1_times.items()})
        # launches on each path: renders (the sharded ones a rank), and gradient runs'
        # forward trips and replays
        if k == "K1":
            paths = dict(k1_launches, **textured, **{"scene6 bvh": s6bl["K1"], "entry": entry_k1})
        elif k == "K5":  # every render: a stage's first test and one an iteration, on the card
            paths = {"cornell": cl["K5"], "scene6": s6l["K5"], "bigmesh": bl["K5"], "balls": ball["K5"],
                     "env": el["K5"], **textured_k5, "scene6 bvh": s6bl["K5"], "bigmesh bvh": bbl["K5"]}
        elif k in ("KW1", "KW2", "film add", "film resolve"):  # every render: once an iteration; a launch; a call
            paths = {label: n[k] for label, n in render_counts.items()}
        elif k in ("K5 gate", "K5 countdown"):  # every gradient pass by the graphs: once a trip and a chunk
            paths = {label: (g["graphs"] if "graphs" in g else g)["counts"][k] for label, g in grads.items()}
        else:
            paths = {"K2": {"scene6": s6l["K2"]}, "K3": {"bigmesh": bl["K3"]},
                     "K4": {"scene6 bvh": s6bl["K4"], "bigmesh bvh": bbl["K4"]}}[k]
        for label, run_ in sharded.items():
            for what, v in run_.items():
                v = v.get("rank 0", v) if isinstance(v, dict) else {}
                if v.get("launches", {}).get(k):
                    paths[f"{label}, {what} (a rank)"] = v["launches"][k]
        for label, g in grads.items():
            if g["launches_forward"].get(k):
                paths[f"{label} forward"] = g["launches_forward"][k]
                paths[f"{label} replay"] = g["launches_replay"][k]
        for label, g in RENDER_GRADS.items():  # render_grads by the graphs: forward trips and replays
            counts = g.get("counts") or g["graphs"]["counts"]
            if counts.get(k):
                paths[f"render_grads {label}"] = counts[k]
        kernels[-1]["launches_by_path"] = paths
        if k in ("KW1", "KW2"):  # the last stage's state beside stage 0's; plain_ms is _stream_step's whole iteration
            kernels[-1].update(lanes=wf0["lanes"], iteration_ms=wf0["iteration_ms"], bytes=wf0[k]["bytes"],
                               lanes_tail=wf_tail["lanes"], ms_tail=wf_tail[k]["ms"],
                               plain_ms_tail=wf_tail["plain_iteration_ms"], bound_ms_tail=wf_tail[k]["bound_ms"],
                               bytes_tail=wf_tail[k]["bytes"], iteration_ms_tail=wf_tail["iteration_ms"])
        if k in ("film add", "film resolve"):  # both frames; resolve's plain_ms is numpy's on the host
            kernels[-1].update(shapes=film_times, elements_compared=film_compared[k],
                               plain_on="card" if k == "film add" else "host")
        if k == "K4":  # both shapes, and K2 / K3 on the same batches; the matmul sweep beside K2
            kernels[-1].update(shapes={shape: dict(v, launches=paths[f"{shape} bvh"])
                                       for shape, v in k4_times.items()},
                               clusters_on_the_same_rays=same_rays, mxu_path=mxu)
    return kernels, grads, sharded


def device_kernels(prof):
    """(device kernel events, their device time in us, their count) of a profile."""
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    return kernels, sum(e.self_device_time_total for e in kernels), sum(e.count for e in kernels)


GRAD_PROFILE = {}  # --profile: the gradient pass's device time and busy share by route


def profile_grads(out_dir, compiled, cam, spp, replicas):
    """torch.profiler over the eager route's forward trips alone (trace_film_scan, no autograd
    graph) and over one eager render_film_grads call (plain_grads): device kernel time,
    kernels a trip, what the backward pass adds a trip. torch.profiler does not trace CUDA
    graphs (PERF.md §7), so the busy share of each route is that device time (the graphs run
    the same kernels at the same shapes, with bit-equal films) over the route's own forward
    and whole wall time, measured without the profiler (the graphs' call a replay)."""
    from torch.profiler import ProfilerActivity, profile

    from tpupt_torch.render.diff import film_lanes, trace_film_scan

    os.makedirs(out_dir, exist_ok=True)
    dev = compiled.data.device
    pix, rows, cols, sample0, _, r, k = film_lanes(cam, spp, replicas, None, dev)
    for route in ("graphs", "eager"):  # warm-up; the graphs' first call captures
        grads_call(compiled, cam, spp, replicas, route)
    walls = {route: grads_call(compiled, cam, spp, replicas, route)[3] for route in ("graphs", "eager")}
    counts, dev_ms = {}, {}
    for phase in ("forward", "forward+backward"):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            if phase == "forward":  # the same trips without autograd: nothing saved, nothing replayed
                stats = {}
                trace_film_scan(compiled.data, cam.init(dev), pix, rows, cols, sample0, spp, 0, k, cam.max_depth,
                                compiled.has_lights, stats=stats)
                trips = stats["trips"]
            else:
                trips = grads_call(compiled, cam, spp, replicas, "eager")[2].trips
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        kernels, dev_us, n = device_kernels(prof)
        counts[phase], dev_ms[phase] = n, dev_us / 1e3
        path = os.path.join(out_dir, f"grads_profile_{phase.replace('+', '_')}.txt")
        with open(path, "w") as f:
            f.write(prof.key_averages().table(sort_by="cuda_time_total", row_limit=40))
        top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:5]
        log(f"profile grads [{phase}] {cam.image_width}x{cam.image_height} {spp} spp, eager route (under the "
            f"profiler): wall {wall:.3f} s, {trips} trips, device kernel time {dev_us / 1e3:.3f} ms "
            f"({100 * dev_us / 1e6 / wall:.2f}% busy), {n} device kernels ({n / max(trips, 1):.0f} a "
            f"trip); top: " + "; ".join(f"{e.key[:60]} {e.self_device_time_total / 1e3:.3f} ms" for e in top)
            + f"; table in {path}")
    busy = {route: dict(forward=dev_ms["forward"] / 1e3 / w["forward_s"],
                        forward_backward=dev_ms["forward+backward"] / 1e3 / w["wall_s"],
                        forward_s=w["forward_s"], wall_s=w["wall_s"]) for route, w in walls.items()}
    GRAD_PROFILE.update(device_ms=dev_ms, kernels=counts, trips=trips, busy=busy)
    log(f"profile grads: the backward pass adds {(counts['forward+backward'] - counts['forward']) / max(trips, 1):.0f} "
        f"device kernels a trip (its replay of the forward trip included); busy share (the eager route's device "
        f"time over each route's wall, without the profiler): " + ", ".join(
            f"{route} forward {100 * b['forward']:.2f}%, forward+backward {100 * b['forward_backward']:.2f}%"
            for route, b in busy.items()))


PROFILES = {}  # --profile: each render's device busy share by route


def profile_render(out_dir, label, render_image, compiled, cam):
    """Device busy share of the second launch of a 2 spp render (one sample a launch) by each
    route. torch.profiler over the graphs lost kernel records and then hit an illegal address
    (PERF.md §7), so it runs over the eager loop's second launch alone: its kernels are the
    graphs' kernels at the same shapes, with bit-equal outputs. The share is that launch's
    device kernel time over the wall time of the same launch by each route, each measured
    without the profiler (the graphs' second launch is a replay)."""
    from torch.profiler import ProfilerActivity, profile

    from tpupt_torch.render.renderer import plain_launches

    def second_launch(route, prof=None):
        stamps = []

        def on_launch(_mean, _done):
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())
            if prof is not None and len(stamps) == 1:
                prof.start()

        with plain_launches() if route == "eager" else contextlib.nullcontext():
            _, _, st = render_image(compiled, cam, progress=False, samples_per_launch=1, on_launch=on_launch)
        torch.cuda.synchronize()
        if prof is not None:
            prof.stop()
        if st.launches != 2:
            raise SystemExit(f"chip_smoke: the {label} profile render made {st.launches} launches, not 2")
        return stamps[1] - stamps[0], st

    os.makedirs(out_dir, exist_ok=True)
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    second_launch("eager", prof)
    events = prof.key_averages()
    path = os.path.join(out_dir, f"render_profile_{label}.txt")
    with open(path, "w") as f:
        f.write(events.table(sort_by="cuda_time_total", row_limit=40))
    # device-side entries only: an operator's own row repeats its kernels' time
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = sum(e.self_device_time_total for e in kernels)
    n_kernels = sum(e.count for e in kernels)
    ours = {name: sum(e.self_device_time_total for e in kernels if name in e.key)
            for name in ("closest_sphere_quad_kernel", "closest_tri_flat_kernel",
                         "closest_tri_two_level_kernel", "closest_tri_bvh_kernel")}
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:5]
    walls = {route: second_launch(route) for route in ("eager", "graphs")}
    PROFILES[label] = dict(device_ms=dev_us / 1e3, kernels=n_kernels, **{
        route: dict(launch_s=wall, busy=dev_us / 1e6 / wall, iterations_both_launches=st.iterations,
                    capture_s=st.capture_s) for route, (wall, st) in walls.items()})
    log(f"profile {label} {cam.image_width}x{cam.image_height} 2 spp, second launch: device kernel time "
        f"{dev_us / 1e3:.3f} ms in {n_kernels} device kernels (eager loop, under the profiler); wall of the "
        f"launch " + ", ".join(f"{route} {wall:.4f} s ({100 * dev_us / 1e6 / wall:.2f}% busy)"
                               for route, (wall, _) in walls.items())
        + f"; {walls['graphs'][1].iterations} iterations in both launches; hand-written kernels "
        + ", ".join(f"{k} {v / 1e3:.3f} ms" for k, v in ours.items() if v)
        + "; top: " + "; ".join(f"{e.key[:60]} {e.self_device_time_total / 1e3:.3f} ms" for e in top)
        + f"; table in {path}")


if __name__ == "__main__":
    raise SystemExit(main())
