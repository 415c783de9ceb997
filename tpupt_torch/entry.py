"""Entry points of the port that stand beside ``__graft_entry__.py``'s.

- ``entry(device=None) -> (fn, args)``: a forward step of the flagship pipeline, the
  Cornell box path-traced (camera rays, closest hit through K1, every material, NEE +
  MIS, russian roulette) on 4096 lanes; ``fn(*args)`` is the radiance [4096, 3].
- ``dryrun_multichip(n_devices, device=None)``: spawns one process a device over
  torch.distributed and runs the JAX version's four checks in every rank, with its
  tolerances: render_image(mesh=...) against the one-device render, the sharded block
  render, the (2 hosts x n/2 chips) pod mesh against the flat one, and the sharded
  gradients against the one-device gradients.

The card is the default: NCCL, one rank a card (fewer than n visible cards raise; no
smaller mesh, no CPU). ``device="cpu"`` runs gloo ranks on the CPU, the counterpart of
the JAX version's forced CPU platform:

    python -c "from tpupt_torch.entry import dryrun_multichip; dryrun_multichip(4, device='cpu')"
"""

from __future__ import annotations

import os
import shutil
import tempfile
import time
import traceback

import numpy as np
import torch

from .core.device import resolve_device

JOIN_S = 600  # the ranks' deadline
GRACE_S = 10.0  # how long the other ranks may take to fail after the first failure


def _cornell(width=64, spp=8, device=None):
    from .scenes import cornell_box_scene

    scene, cam = cornell_box_scene(width, spp)
    return scene.compile(device=device), cam


def entry(device=None):
    """The Cornell box at 64 px, 8 spp, over 4096 lanes: pixels arange(4096) % (w*h),
    sample 0, seed 0, max_depth 50 -> (fn, (SceneData, CameraData, pixels)); fn(*args)
    returns the radiance [4096, 3] of trace_radiance, on the card unless `device` says."""
    from .render.integrator import trace_radiance

    dev = resolve_device(device)
    compiled, camera = _cornell(device=dev)
    w = camera.image_width
    pix = torch.arange(4096, dtype=torch.int32, device=dev) % (w * camera.image_height)

    def fn(sd, cam, pix):
        radiance, _ = trace_radiance(sd, cam, pix, pix // w, pix % w, torch.zeros_like(pix), 0,
                                     max_depth=50, has_lights=True)
        return radiance

    return fn, (compiled.data, camera.init(dev), pix)


def _expect(ok, what):
    if not ok:
        raise AssertionError(what)


def _checks(n, dev):
    """The four checks of __graft_entry__.dryrun_multichip in this rank -> what they saw.
    A failed check raises AssertionError (also under python -O)."""
    import torch.distributed as dist

    from .ops import hit_kernel
    from .parallel.multihost import make_pod_mesh, render_block_pod
    from .parallel.sharding import make_mesh, render_block_sharded, render_grads_sharded
    from .render.diff import render_grads
    from .render.renderer import render_image

    hit_kernel.launches = 0
    compiled, camera = _cornell(width=16, spp=2 * n, device=dev)
    mesh = make_mesh(n, device=dev)
    npix = camera.image_width * camera.image_height
    ids = np.arange(npix, dtype=np.int32)
    rows, cols = ids // camera.image_width, ids % camera.image_width
    out = {"rank": dist.get_rank(), "world": n, "device": str(dev)}

    _, mean_mesh, st_mesh = render_image(compiled, camera, progress=False, mesh=mesh)
    _, mean_one, st_one = render_image(compiled, camera, progress=False)
    _expect(np.isfinite(mean_mesh).all(), "multichip film invalid")
    _expect(st_mesh.rays == st_one.rays, "mesh render traced different paths")
    _expect(np.allclose(mean_mesh, mean_one, rtol=1e-4, atol=1e-6), "mesh render_image diverges from single-device")
    out["render_image"] = dict(rays=st_mesh.rays, max_abs_diff=float(np.abs(mean_mesh - mean_one).max()))

    film, rays = render_block_sharded(compiled, camera, ids, rows, cols, spp=2 * n, mesh=mesh)
    _expect(film.shape == (npix, 3) and bool(torch.isfinite(film).all()), "multichip film invalid")
    _expect(rays > 0, "multichip render traced no rays")
    out["render_block_sharded"] = dict(rays=rays)

    if n >= 2 and n % 2 == 0:  # the 2-D pod layout: host x chip axes, the film summed per axis
        pod = make_pod_mesh(n_hosts=2, chips_per_host=n // 2, device=dev)
        film_pod, _ = render_block_pod(compiled, camera, ids, rows, cols, spp=2 * n, mesh=pod)
        _expect(torch.allclose(film_pod, film, rtol=1e-4, atol=1e-5), "pod mesh film diverges from flat mesh")
        out["render_block_pod"] = dict(max_abs_diff=float((film_pod - film).abs().max()))

    _, grads = render_grads_sharded(compiled, camera, ids[:32], rows[:32], cols[:32], spp=n, mesh=mesh)
    _, grads_one = render_grads(compiled, camera, ids[:32], spp=n)
    total = 0.0
    for name, g in grads.items():
        _expect(bool(torch.isfinite(g).all()), "sharded grads non-finite")
        _expect(torch.allclose(g, grads_one[name], rtol=2e-4, atol=1e-5),
                f"sharded grad {name} diverges from single-device")
        total += float(g.abs().sum())
    _expect(total > 0.0, "sharded grads all zero")
    out["render_grads_sharded"] = dict(grad_abs_sum=total)
    out["K1_launches"] = hit_kernel.launches
    return out


def _rank(rank, n, store, out_dir, device_type, checks):
    """A spawned rank: join the group (NCCL on cuda:rank, or gloo on the CPU), run
    checks(n, device), and save what it returns, or its failure, to out_dir."""
    import torch.distributed as dist

    if device_type == "cuda":
        dev = torch.device(f"cuda:{rank}")
        torch.cuda.set_device(dev)
        backend = "nccl"
    else:
        dev, backend = torch.device("cpu"), "gloo"
        torch.set_num_threads(1)
    # a world of 1 joins too: the mesh then reduces over a real (NCCL or gloo) group
    dist.init_process_group(backend, init_method=f"file://{store}", world_size=n, rank=rank)
    try:
        res = checks(n, dev)
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))


def dryrun_multichip(n_devices: int, device=None) -> list[dict]:
    """Run the dry run over n_devices ranks, one process each -> each rank's summary
    (rays, the largest differences, K1's launches in that rank). Raises if a rank fails a
    check, exits otherwise or outlives JOIN_S."""
    dev = resolve_device(device)
    if dev.type == "cuda" and torch.cuda.device_count() < n_devices:
        raise RuntimeError(
            f"dryrun_multichip: {n_devices} ranks need {n_devices} cards, {torch.cuda.device_count()} visible "
            "(one rank a card; pass device='cpu' for gloo ranks on the CPU)"
        )
    return run_ranks(n_devices, dev.type, _checks, JOIN_S)


def run_ranks(n, device_type, checks, timeout_s):
    """Spawn n ranks that each run checks(n, device) (a module-level function) -> what
    each returned, in rank order. Raises if a rank fails, or outlives timeout_s; the
    other ranks are then killed."""
    import torch.multiprocessing as mp

    out_dir = tempfile.mkdtemp(prefix="tpupt_dryrun_")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank, args=(r, n, os.path.join(out_dir, "store"), out_dir, device_type, checks))
             for r in range(n)]
    try:
        for p in procs:
            p.start()
        failed = _join(procs, out_dir, timeout_s)
        if failed:
            raise RuntimeError("dryrun_multichip: " + "; ".join(failed))
        return [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False) for r in range(n)]
    finally:
        for p in procs:  # a rank left waiting on a collective of one that failed
            if p.is_alive():
                p.kill()
                p.join(10)
        shutil.rmtree(out_dir, ignore_errors=True)


def _join(procs, out_dir, timeout_s):
    """Wait for every rank until the deadline, or until GRACE_S after the first failure
    (the others may fail on the collective it left) -> the failures, by rank."""
    from multiprocessing.connection import wait

    deadline = time.monotonic() + timeout_s
    pending, failed = dict(enumerate(procs)), {}
    while pending:
        if not wait([p.sentinel for p in pending.values()], timeout=max(deadline - time.monotonic(), 0.0)):
            if not failed:
                failed = {r: f"rank {r} did not finish in {timeout_s} s" for r in pending}
            break
        for r, p in list(pending.items()):
            if p.is_alive():
                continue
            p.join()
            del pending[r]
            if p.exitcode != 0:
                err = os.path.join(out_dir, f"rank{r}.err")
                why = open(err).read().strip().splitlines()[-1] if os.path.exists(err) else "no report"
                failed[r] = f"rank {r} exited with {p.exitcode}: {why}"
                deadline = min(deadline, time.monotonic() + GRACE_S)
    return [failed[r] for r in sorted(failed)]
