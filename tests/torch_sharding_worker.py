"""Ranks of the port's sharded checks (tests/test_torch_sharding.py), spawned on the CPU.

Each rank joins a gloo process group through a file store, runs the sharded entry
points on its own sample slice and saves what it got to `<out>/<world>_rank<i>.pt`.
It imports no JAX: the test process holds the single-device and reference results.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from tpupt_torch.parallel.multihost import initialize_distributed, make_pod_mesh, render_block_pod
from tpupt_torch.parallel.sharding import make_mesh, render_block_sharded, render_grads_sharded
from tpupt_torch.render.camera import Camera
from tpupt_torch.render.diff import SEGMENT, RadianceScanStages, init_params, segmented_film_vjp
from tpupt_torch.render.renderer import render_image
from tpupt_torch.scene.builder import Diffuse, Light, Scene
from tpupt_torch.scenes import cornell_box_scene


def tiny_scene():
    """tests/test_sharding.py's tiny scene on the port: a sphere under a quad light, 8x8."""
    s = Scene()
    s.add_sphere(1.0, (0.0, 0.0, -3.0), Diffuse((0.6, 0.5, 0.4)))
    s.add_quad((-1.0, 2.5, -4.0), (2.0, 0.0, 0.0), (0.0, 0.0, 2.0), Light((6.0, 6.0, 6.0)), light=True)
    s.environment = (0.2, 0.3, 0.4)
    cam = Camera(
        aspect_ratio=1.0, image_width=8, samples_per_pixel=16, max_depth=6,
        vfov=30.0, look_from=(0, 0, 0), look_at=(0, 0, -1),
        blur_strength=0.5, focal_length=3.0, defocus_angle=0.0,
    )
    return s, cam


def grads_scene():
    """tests/test_sharding.py's gradient check: Cornell 8x8, 8 spp, max_depth 6, 16 pixels."""
    scene, cam = cornell_box_scene(8, 8)
    cam.max_depth = 6
    return scene, cam, np.arange(16, dtype=np.int32)


def dead_rank_lanes(rank, w=64):
    """Cornell at w px, max_depth 24 (3 backward segments), 8 samples of 64 pixels: rank 0's
    pixels are the top row, whose rays pass above the box and miss (every lane dies at
    bounce 0), rank 1's sit in the middle of the box (paths live past bounce 8)."""
    scene, cam = cornell_box_scene(w, 8)
    cam.max_depth = 24
    if rank == 0:
        ids = np.arange(w)
    else:
        ids = np.concatenate([(w // 2) * w + np.arange(16, 48), (w // 2 + 1) * w + np.arange(16, 48)])
    pix = torch.from_numpy(np.repeat(ids, 8).astype(np.int32))
    samples = torch.arange(8, dtype=torch.int32).repeat(len(ids))
    return scene, cam, pix, samples


def dead_rank_vjp(compiled, cam, pix, samples, mesh=None):
    sd = compiled.data
    cot = torch.full((pix.shape[0], 3), 1.0 / 8)
    return segmented_film_vjp(init_params(sd), sd, cam.init("cpu"), pix, pix // cam.image_width,
                              pix % cam.image_width, samples, 0, cam.max_depth,
                              compiled.has_lights, cot, mesh=mesh)


def _run_4(mesh, out, rank):
    res = {}
    scene, cam = cornell_box_scene(24, 16)
    _, mean, st = render_image(scene.compile(device="cpu"), cam, progress=False, mesh=mesh)
    res["render"] = (mean, st.rays, st.paths, st.launches, st.iterations)

    s, tcam = tiny_scene()
    tiny = s.compile(device="cpu")
    ids = np.arange(64, dtype=np.int32)
    film, rays = render_block_sharded(tiny, tcam, ids, ids // 8, ids % 8, spp=16, mesh=mesh)
    res["block"] = (film.numpy(), rays)

    pod = make_pod_mesh(2, 2, device="cpu")
    film, rays = render_block_pod(tiny, tcam, ids, ids // 8, ids % 8, spp=16, mesh=pod)
    res["pod"] = (film.numpy(), rays, pod.host, pod.chip)
    try:
        make_pod_mesh(4, 4, device="cpu")
    except RuntimeError as e:
        res["pod_error"] = str(e)

    # the multi-launch checkpoint: k=1, r=4 on 4 ranks -> 16 samples a launch, 2 launches
    scene, cam = cornell_box_scene(16, 32)
    compiled = scene.compile(device="cpu")
    kw = dict(progress=False, mesh=mesh, samples_per_launch=1)
    _, full, st = render_image(compiled, cam, **kw)
    ck = os.path.join(out, "film.npz")

    class Stop(Exception):
        pass

    def interrupt(_mean, _frac):
        raise Stop

    try:
        render_image(compiled, cam, checkpoint_path=ck, on_launch=interrupt, **kw)
    except Stop:
        pass
    next_it = int(np.load(ck)["next_it"])
    _, resumed, st2 = render_image(compiled, cam, checkpoint_path=ck, **kw)
    res["checkpoint"] = (full, st.launches, next_it, resumed, st2.launches)

    scene, cam, ids = grads_scene()
    film, grads = render_grads_sharded(scene.compile(device="cpu"), cam, ids, ids // 8, ids % 8,
                                       spp=8, mesh=mesh)
    res["grads"] = (film.numpy(), {k: v.numpy() for k, v in grads.items()})
    return res


def _run_2(mesh, out, rank):
    scene, cam = cornell_box_scene(24, 16)
    _, mean, st = render_image(scene.compile(device="cpu"), cam, progress=False, mesh=mesh)
    scene, dcam, pix, samples = dead_rank_lanes(rank)
    radiance, grads = dead_rank_vjp(scene.compile(device="cpu"), dcam, pix, samples, mesh=mesh)
    return {"render": (mean, st.rays, st.paths, st.launches, st.iterations),
            "dead": (radiance.numpy(), {k: v.numpy() for k, v in grads.items()})}


class CountingMesh:
    """A mesh that counts the all-reduces issued through it."""

    def __init__(self, mesh):
        self.mesh, self.calls = mesh, 0

    def all_reduce(self, tensor, async_op=False):
        self.calls += 1
        return self.mesh.all_reduce(tensor, async_op=async_op)


def radiance_runner_worker(rank, world, store, out):
    """A rank of tests/test_torch_radiance_graph.py's mesh check on dead_rank_lanes: the eager
    segmented_film_vjp and the stage runner's pass (RadianceScanStages.run with the mesh,
    chunks of one segment) over the same mesh, each counting its collectives."""
    torch.set_num_threads(1)
    initialize_distributed(f"file://{store}", num_processes=world, process_id=rank, backend="gloo",
                           device="cpu")
    try:
        mesh = CountingMesh(make_mesh(world, device="cpu"))
        scene, cam, pix, samples = dead_rank_lanes(rank)
        compiled = scene.compile(device="cpu")
        radiance, grads = dead_rank_vjp(compiled, cam, pix, samples, mesh=mesh)
        eager_calls, mesh.calls = mesh.calls, 0
        sd, w = compiled.data, cam.image_width
        st = RadianceScanStages(sd, cam.init("cpu"), pix.shape[0], cam.max_depth, compiled.has_lights, "cpu",
                                chunk=SEGMENT)
        st.set_inputs(pix, pix // w, pix % w, samples, init_params(sd), torch.full((pix.shape[0], 3), 1.0 / 8), 0)
        log = []
        out_l, out_g, rays, trips = st.run(log=log, mesh=mesh)
        torch.save({"eager": (radiance, grads, eager_calls),
                    "runner": (out_l.clone(), {k: v.clone() for k, v in out_g.items()}, mesh.calls, rays, trips, log)},
                   os.path.join(out, f"radiance_rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def failing_checks(n, dev):
    """tests/test_torch_entry.py's planted failure: rank 1 fails its check, rank 0 waits
    for it in a collective that never completes."""
    rank = dist.get_rank()
    assert rank != 1, f"planted in rank {rank}"
    dist.all_reduce(torch.zeros(1))
    return {}


def card_worker(rank, world, store, out):
    """A rank of tests/test_torch_cuda.py's two-rank check: gloo, every rank on cuda:0
    (NCCL puts no two ranks of a communicator on one card)."""
    initialize_distributed(f"file://{store}", num_processes=world, process_id=rank, backend="gloo",
                           device="cuda:0")
    try:
        scene, cam = cornell_box_scene(32, 8)
        _, mean, st = render_image(scene.compile(device="cuda:0"), cam, progress=False,
                                   mesh=make_mesh(world, device="cuda:0"))
        torch.save((mean, st.rays), os.path.join(out, f"card_rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def worker(rank, world, store, out):
    """Entry point of a spawned rank."""
    torch.set_num_threads(1)
    initialize_distributed(f"file://{store}", num_processes=world, process_id=rank, backend="gloo",
                           device="cpu")
    try:
        mesh = make_mesh(world, device="cpu")
        res = (_run_4 if world == 4 else _run_2)(mesh, out, rank)
        torch.save(res, os.path.join(out, f"{world}_rank{rank}.pt"))
    finally:
        dist.destroy_process_group()
