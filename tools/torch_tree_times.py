"""Times of one checkout of the PyTorch/CUDA port on one card: its kernels on the ray
batches of a render, and the four full-width renders of chip_smoke.py.

For comparing two checkouts (a commit and its parent, or a copy with a constant of
a kernel source changed): run it from the root of each in turns (a, b, b, a) on
one card. ``tpupt_torch`` is imported from the working directory and called through
its public entry points only (``hit_kernel.tables``, ``closest_sphere_quad``,
``closest_tri``, ``render_image``); the scenes and the ray batches come from the
chip_smoke.py of the checkout that holds this file, so every checkout is given the
same rays.

    cd <checkout> && python <this checkout>/tools/torch_tree_times.py LABEL \\
        [--kernels [K1,K2,K3]] [--renders N [--scenes cornell,balls]]

--kernels: K1 on six batches (the tables of Cornell, the scene-6 stand-in and the
balls scene; the camera rays and the bounce rays that follow their hits); K2 (scene-6
stand-in) and K3 (bigmesh stand-in) on four batches: the camera rays, the two bounce
batches that follow them, and a "close-up" (the camera rays squeezed to 3% of their
spread about the central ray, so that a warp's 32 rays share their clusters). A list
after the option keeps to the kernels named. Per batch one JSON line: device ms (a
spin kernel holds the stream while the host enqueues a round, so the calls run back
to back whatever the host's pace), the host's ms to enqueue one call, and a checksum
of the outputs' bits, equal between checkouts that compute the same function.
--renders N: N renders of each scene after a 1 spp warm-up, one JSON line each;
--scenes keeps to the scenes named (cornell, scene6, bigmesh, balls).
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np
import torch

SPIN_CYCLES = 20_000_000  # ~10 ms of the card: longer than the host needs to enqueue a round


def device_and_host_ms(fn, reps=20, rounds=7):
    """(median device ms of a call, median host ms to enqueue it) over `rounds` of `reps`."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    dev, host = [], []
    for _ in range(rounds):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)  # private to torch, the one spin kernel it ships
        start.record()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        host.append(1e3 * (time.perf_counter() - t0) / reps)
        end.record()
        torch.cuda.synchronize()
        dev.append(start.elapsed_time(end) / reps)
    return float(np.median(dev)), float(np.median(host))


def checksum(*parts):
    """The sum of the outputs' bit patterns: equal for equal outputs."""
    return int(sum(int(x.contiguous().view(torch.int32).to(torch.int64).sum()) for x in parts))


def kernels(CS, label, dev, card, which):
    from tpupt_torch.ops import hit_kernel
    from tpupt_torch.ops.tri_kernel import closest_tri
    from tpupt_torch.scenes import balls_scene, cornell_box_scene, everything_scene

    scene6 = everything_scene(600, CS.SPP["scene6"])
    k1_scenes = {"cornell": cornell_box_scene(600, CS.SPP["cornell"]), "scene6": scene6,
                 "balls": balls_scene(600, CS.SPP["balls"])}
    for seed, (shape, (scene, cam)) in enumerate(k1_scenes.items() if "K1" in which else ()):
        sd = scene.compile(device=dev).data
        sph, quad = hit_kernel.tables(sd)
        for kind, rays in CS.k1_batches(hit_kernel, sd, cam, dev, seed + 20).items():
            ms, host_ms = device_and_host_ms(lambda: hit_kernel.closest_sphere_quad(*rays, sph, quad))
            print(json.dumps(dict(
                tree=label, kernel=f"K1 {shape}", batch=kind, rays=rays[0].shape[0],
                S=sph.shape[1], Q=quad.shape[1], ms=ms, host_ms=host_ms,
                checksum=checksum(*hit_kernel.closest_sphere_quad(*rays, sph, quad)), card=card)),
                flush=True)

    for name, (scene, cam) in (("K2 scene 6 stand-in", scene6),
                               ("K3 bigmesh stand-in", CS.bigmesh_scene(600, CS.SPP["bigmesh"]))):
        if name[:2] not in which:
            continue
        sd = scene.compile(device=dev).data
        o, d, t = CS.camera_rays(cam, dev)
        camera = (o, d, torch.full_like(t, 3e38))
        center = d.mean(dim=0, keepdim=True)
        squeezed = center + 0.03 * (d - center)
        batches = {"close-up": (o, (squeezed / squeezed.norm(dim=1, keepdim=True)).contiguous(), camera[2])}
        batch = camera
        for depth, kind in enumerate(("camera", "bounce 1", "bounce 2")):
            batches[kind] = batch
            kt, _, ka = closest_tri(sd, *batch, 1e-3)
            batch = CS.bounce_rays(batch[0], batch[1], kt, ka["ns_raw"], seed=17 + depth)
        for kind, rays in batches.items():
            ms, host_ms = device_and_host_ms(lambda: closest_tri(sd, *rays, 1e-3))
            t, idx, aux = closest_tri(sd, *rays, 1e-3)
            print(json.dumps(dict(
                tree=label, kernel=name, batch=kind, rays=rays[0].shape[0],
                alive=float((rays[2] > 0).float().mean()), ms=ms, host_ms=host_ms,
                checksum=checksum(t, idx, aux["ns_raw"], aux["u"], aux["v"], aux["mat"]), card=card)),
                flush=True)


def renders(CS, label, dev, card, n, scenes):
    from tpupt_torch.render.renderer import render_image
    from tpupt_torch.scenes import balls_scene, cornell_box_scene, everything_scene

    for key, name, build in (("cornell", "cornell", cornell_box_scene),
                             ("scene6", "scene 6 stand-in", everything_scene),
                             ("bigmesh", "bigmesh stand-in", CS.bigmesh_scene),
                             ("balls", "balls", balls_scene)):
        if key not in scenes:
            continue
        spp = CS.SPP[key]
        scene, cam = build(600, 1)
        render_image(scene.compile(device=dev), cam, seed=0, progress=False)  # builds, warms up
        scene, cam = build(600, spp)
        compiled = scene.compile(device=dev)
        for rep in range(n):
            torch.cuda.synchronize()
            _, _, st = render_image(compiled, cam, seed=0, progress=False)
            torch.cuda.synchronize()
            print(json.dumps(dict(
                tree=label, render=name, rep=rep, wall_s=st.wall_s, paths_per_s=st.paths_per_s,
                rays_per_s=st.rays_per_s, iterations=st.iterations,
                ms_per_iteration=1e3 * st.wall_s / st.iterations, card=card)), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("label", help="names this checkout in the output")
    ap.add_argument("--kernels", nargs="?", const="K1,K2,K3", default="", metavar="K1,K2,K3")
    ap.add_argument("--renders", type=int, default=0, metavar="N")
    ap.add_argument("--scenes", default="cornell,scene6,bigmesh,balls")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_tree_times: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.getcwd())  # tpupt_torch of the checkout to measure
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(here, "chip_smoke.py"))
    CS = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(CS)

    dev = torch.device("cuda")
    card = CS.card_line()
    asset_dir = tempfile.mkdtemp(prefix="tpupt_assets_")
    try:
        os.environ["TPUPT_ASSETS"] = asset_dir
        CS.write_stand_in_assets(asset_dir)
        if args.kernels:
            kernels(CS, args.label, dev, card, args.kernels.split(","))
        if args.renders:
            renders(CS, args.label, dev, card, args.renders, args.scenes.split(","))
    finally:
        shutil.rmtree(asset_dir, ignore_errors=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
