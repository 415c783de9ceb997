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
        [--kernels [K1,K2,K3,K4]] [--renders N [--scenes cornell,balls] [--profile]]

--kernels: K1 on six batches (the tables of Cornell, the scene-6 stand-in and the
balls scene; the camera rays and the bounce rays that follow their hits); K2 (scene-6
stand-in) and K3 (bigmesh stand-in) on four batches: the camera rays, the two bounce
batches that follow them, and a "close-up" (the camera rays squeezed to 3% of their
spread about the central ray, so that a warp's 32 rays share their clusters); K4 on
the scene-6 and bigmesh stand-ins compiled with bvh=True, on chip_smoke.py's two
batches (camera rays, and the bounce rays about the face normal of each camera ray's
triangle, dead where it missed), the bounce batch's live lanes alone, and the camera
batch with every lane dead; through either signature of closest_tri_bvh (PR 7's takes
no t_in and walks dead lanes; its checksum counts the live lanes' t and idx, which both
give, and the attributes are summed apart), with the counts of the walk where the
checkout has ``bvh_kernel.walk_counts``. A list after the option keeps to the kernels
named. Per batch one JSON line: device ms (a
spin kernel holds the stream while the host enqueues a round, so the calls run back
to back whatever the host's pace), the host's ms to enqueue one call, and a checksum
of the outputs' bits, equal between checkouts that compute the same function.
--renders N: N renders of each scene after a 1 spp warm-up, one JSON line each;
--scenes keeps to the scenes named (cornell, scene6, bigmesh, balls, scene6_bvh,
bigmesh_bvh: the two mesh scenes compiled with bvh=True). --profile adds, per scene, one
2 spp render under torch.profiler: device kernels per iteration and the device's busy
share.
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


def k4_call(sd):
    """f(o, d, t_in) -> (t, idx, aux or None) through the checkout's closest_tri_bvh."""
    from tpupt_torch.ops import bvh_kernel

    tables = bvh_kernel.scene_nodes(sd)
    if len(tables) == 3:  # (nodes, tris, attr): (o, d, t_in, tmin, ...) -> (t, idx, aux)
        return lambda o, d, t_in: bvh_kernel.closest_tri_bvh(o, d, t_in, 1e-3, *tables)
    return lambda o, d, t_in: (*bvh_kernel.closest_tri_bvh(o, d, 1e-3, 3e38, *tables), None)  # PR 7


def k4_kernels(CS, label, dev, card):
    from tpupt_torch.ops import bvh_kernel
    from tpupt_torch.scenes import everything_scene

    for name, (scene, cam) in (("K4 scene 6 stand-in", everything_scene(600, CS.SPP["scene6"])),
                               ("K4 bigmesh stand-in", CS.bigmesh_scene(600, CS.SPP["bigmesh"]))):
        sd = scene.compile(device=dev, bvh=True).data
        k4 = k4_call(sd)
        o, d, _ = CS.camera_rays(cam, dev)
        camera = (o, d, torch.full((o.shape[0],), 3e38, device=dev))
        t, idx, _ = k4(*camera)
        n = torch.linalg.cross(sd.tri_e1[idx.long()], sd.tri_e2[idx.long()])
        bounce = CS.bounce_rays(o, d, t, n, 30)
        live = bounce[2] > 0
        batches = {"camera": camera, "bounce": bounce,
                   "bounce, live lanes alone": tuple(x[live].contiguous() for x in bounce),
                   "camera, every lane dead": (o, d, torch.zeros_like(camera[2]))}
        for kind, rays in batches.items():
            ms, host_ms = device_and_host_ms(lambda: k4(*rays))
            t, idx, aux = k4(*rays)
            live = rays[2] > 0
            walk = {}
            if hasattr(bvh_kernel, "walk_counts"):
                walk = bvh_kernel.walk_counts(*rays, 1e-3, *bvh_kernel.scene_nodes(sd))
            print(json.dumps(dict(
                tree=label, kernel=name, batch=kind, rays=rays[0].shape[0], alive=float(live.float().mean()),
                ms=ms, host_ms=host_ms, checksum=checksum(t[live], idx[live]),
                aux_checksum=None if aux is None else checksum(aux["ns_raw"], aux["u"], aux["v"], aux["mat"]),
                card=card, **walk)), flush=True)


def profile_counts(render_image, compiled, cam):
    """(device kernels per iteration, device busy share) of one render under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, _, st = render_image(compiled, cam, seed=0, progress=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e6 / wall
    return sum(e.count for e in kernels) / max(st.iterations, 1), busy


def renders(CS, label, dev, card, n, scenes, profiled):
    from tpupt_torch.render.renderer import render_image
    from tpupt_torch.scenes import balls_scene, cornell_box_scene, everything_scene

    for key, name, build, bvh in (("cornell", "cornell", cornell_box_scene, None),
                                  ("scene6", "scene 6 stand-in", everything_scene, None),
                                  ("bigmesh", "bigmesh stand-in", CS.bigmesh_scene, None),
                                  ("balls", "balls", balls_scene, None),
                                  ("scene6_bvh", "scene 6 stand-in, bvh=True", everything_scene, True),
                                  ("bigmesh_bvh", "bigmesh stand-in, bvh=True", CS.bigmesh_scene, True)):
        if key not in scenes:
            continue
        spp = CS.SPP[key.split("_")[0]]
        scene, cam = build(600, 1)
        render_image(scene.compile(device=dev, bvh=bvh), cam, seed=0, progress=False)  # builds, warms up
        if profiled:
            scene, cam = build(600, 2)
            per_iteration, busy = profile_counts(render_image, scene.compile(device=dev, bvh=bvh), cam)
            print(json.dumps(dict(tree=label, render=name, profile="2 spp", kernels_per_iteration=per_iteration,
                                  device_busy=busy, card=card)), flush=True)
        scene, cam = build(600, spp)
        compiled = scene.compile(device=dev, bvh=bvh)
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
    ap.add_argument("--kernels", nargs="?", const="K1,K2,K3,K4", default="", metavar="K1,K2,K3,K4")
    ap.add_argument("--renders", type=int, default=0, metavar="N")
    ap.add_argument("--scenes", default="cornell,scene6,bigmesh,balls")
    ap.add_argument("--profile", action="store_true")
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
            if "K4" in args.kernels.split(","):
                k4_kernels(CS, args.label, dev, card)
        if args.renders:
            renders(CS, args.label, dev, card, args.renders, args.scenes.split(","), args.profile)
    finally:
        shutil.rmtree(asset_dir, ignore_errors=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
