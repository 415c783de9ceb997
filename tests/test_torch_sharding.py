"""The port's sample-sharded render and gradients over torch.distributed, on the CPU.

Two and four gloo ranks run in processes spawned with torch.multiprocessing, joined
through a file store in a temp dir (tests/torch_sharding_worker.py; they import no
JAX). Every worker is joined with its own timeout, so a hang fails the tests in
about two minutes instead of stalling the suite.

Tolerances (those of tests/test_sharding.py): a sharded render traces the same
(pixel, sample) paths as one device, only the float32 film sum runs in another
order, so rays are equal and the image mean is within rtol 1e-4 / atol 1e-6 (a
block's film sum within 1e-5 / 1e-6); gradients within rtol 2e-4 / atol 1e-5; a
mesh of one is bit-equal to no mesh. Against the JAX package's sharded film (its
8-device CPU mesh) the port's 4-rank film is held as tests/test_torch_render.py
holds the port against the jitted reference: 99% of paths within rtol 1e-3 / atol
1e-4, so 0.99**16 of the 16-path pixel sums, and the image mean within 0.5%; and its sharded gradients by relative L1 per field, 2e-2,
as in tests/test_torch_grad_ref.py.
"""

import os

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import torch_sharding_worker as W
import torch_cpu_warmup  # noqa: F401  (MKL's first vector-math call, on one thread)
from tpupt.parallel.sharding import make_mesh as j_make_mesh
from tpupt.parallel.sharding import render_block_sharded as j_render_block_sharded
from tpupt.parallel.sharding import render_grads_sharded as j_render_grads_sharded
from tpupt.scenes import cornell_box_scene as j_cornell
from tpupt_torch.parallel.multihost import initialize_distributed
from tpupt_torch.parallel.sharding import make_mesh, render_block_sharded
from tpupt_torch.render.diff import render_grads, trace_radiance_scan
from tpupt_torch.render.renderer import render_image
from tpupt_torch.scenes import cornell_box_scene

from test_sharding import _tiny_scene as j_tiny_scene

JOIN_S = 120  # a worker's own timeout


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Run the 4-rank and the 2-rank worlds at once -> {world: [result of each rank]}."""
    out = str(tmp_path_factory.mktemp("ranks"))
    ctx = mp.get_context("spawn")
    procs = {world: [ctx.Process(target=W.worker, args=(rank, world, os.path.join(out, f"store{world}"), out))
                     for rank in range(world)] for world in (4, 2)}
    for p in (p for ps in procs.values() for p in ps):
        p.start()
    failed = []
    for world, ps in procs.items():
        for rank, p in enumerate(ps):
            p.join(JOIN_S)
            if p.is_alive():
                p.kill()
                p.join(10)
                failed.append(f"world {world} rank {rank} timed out after {JOIN_S} s")
            elif p.exitcode != 0:
                failed.append(f"world {world} rank {rank} exited with {p.exitcode}")
    if failed:
        pytest.fail("; ".join(failed))
    return {world: [torch.load(os.path.join(out, f"{world}_rank{r}.pt"), weights_only=False)
                    for r in range(world)] for world in (4, 2)}


@pytest.fixture(scope="module")
def cornell_one_device():
    scene, cam = cornell_box_scene(24, 16)
    _, mean, st = render_image(scene.compile(device="cpu"), cam, progress=False)
    return mean, st


@pytest.mark.parametrize("world", [2, 4])
def test_render_image_mesh_matches_single_device(ranks, cornell_one_device, world):
    mean1, st1 = cornell_one_device
    for res in ranks[world]:
        mean, rays, paths, launches, iterations = res["render"]
        assert rays == st1.rays and paths == st1.paths
        assert 0 < iterations < st1.iterations  # each rank runs its own, shorter wavefront
        np.testing.assert_allclose(mean, mean1, rtol=1e-4, atol=1e-6)
        np.testing.assert_array_equal(mean, ranks[world][0]["render"][0])  # every rank the same


def test_render_block_sharded_matches_one_rank(ranks):
    s, cam = W.tiny_scene()
    ids = np.arange(64, dtype=np.int32)
    film1, rays1 = render_block_sharded(s.compile(device="cpu"), cam, ids, ids // 8, ids % 8, spp=16,
                                        mesh=make_mesh(device="cpu"))
    for res in ranks[4]:
        film, rays = res["block"]
        assert rays == rays1
        np.testing.assert_allclose(film, film1.numpy(), rtol=1e-5, atol=1e-6)


def test_mesh_of_one_without_process_group_bit_equal():
    scene, cam = cornell_box_scene(16, 8)
    compiled = scene.compile(device="cpu")
    mesh = make_mesh(device="cpu")
    assert mesh.size == 1 and mesh.index == 0 and mesh.group is None
    img0, mean0, st0 = render_image(compiled, cam, progress=False)
    img1, mean1, st1 = render_image(compiled, cam, progress=False, mesh=mesh)
    np.testing.assert_array_equal(mean1, mean0)
    np.testing.assert_array_equal(img1, img0)
    assert (st1.rays, st1.paths, st1.iterations) == (st0.rays, st0.paths, st0.iterations)


def test_make_mesh_without_a_process_group():
    with pytest.raises(RuntimeError, match="requested a 2-device mesh but only 1"):
        make_mesh(2, device="cpu")
    initialize_distributed(num_processes=1)  # one process: nothing to join
    assert not torch.distributed.is_initialized()
    assert make_mesh(1).device == torch.device("cuda:0")  # the card unless the caller says


def test_mesh_checkpoint_resume_bit_identical(ranks):
    for res in ranks[4]:
        full, launches, next_it, resumed, launches2 = res["checkpoint"]
        assert launches == 2 and next_it == 1 and launches2 == 2
        np.testing.assert_array_equal(resumed, full)


def test_pod_mesh_matches_flat_mesh(ranks):
    for rank, res in enumerate(ranks[4]):
        film, rays, host, chip = res["pod"]
        assert (host, chip) == divmod(rank, 2)
        assert rays == res["block"][1]
        np.testing.assert_allclose(film, res["block"][0], rtol=1e-5, atol=1e-6)


def test_pod_mesh_larger_than_the_world_raises(ranks):
    for res in ranks[4]:
        assert "pod mesh (4 hosts x 4 chips) needs 16 devices" in res["pod_error"]


def test_render_grads_sharded_matches_render_grads(ranks):
    scene, cam, ids = W.grads_scene()
    radiance, g1 = render_grads(scene.compile(device="cpu"), cam, ids, spp=8, seed=0)
    assert float(g1["mat_params"].abs().sum()) > 0.0
    for res in ranks[4]:
        film, grads = res["grads"]
        np.testing.assert_allclose(film, radiance.numpy(), rtol=1e-4, atol=1e-5)
        for k, ref in g1.items():
            np.testing.assert_allclose(grads[k], ref.numpy(), rtol=2e-4, atol=1e-5, err_msg=k)


def test_dead_rank_joins_every_segment_collective(ranks):
    """Rank 0's lanes all die at bounce 0, so it skips segments 1 and 2, where rank 1's
    lanes live on: it must still join those segments' all-reduces (with zeros), or the
    two ranks deadlock. The summed grads equal the sum of each rank's own."""
    want = {}
    for rank in (0, 1):
        scene, cam, pix, samples = W.dead_rank_lanes(rank)
        compiled = scene.compile(device="cpu")
        sd, c = compiled.data, cam.init("cpu")
        args = (pix, pix // cam.image_width, pix % cam.image_width, samples, 0)
        _, rays = trace_radiance_scan(sd, c, *args, cam.max_depth, compiled.has_lights, with_rays=True)
        if rank == 0:
            assert rays == pix.shape[0]  # one intersection a lane: all miss
        else:  # some lane is still alive at bounce 8, in the second segment
            _, rays8 = trace_radiance_scan(sd, c, *args, 8, compiled.has_lights, with_rays=True)
            assert rays > rays8
        _, g = W.dead_rank_vjp(compiled, cam, pix, samples)
        want = {k: want.get(k, 0) + v.numpy() for k, v in g.items()}
    for res in ranks[2]:
        _, grads = res["dead"]
        assert np.abs(grads["mat_params"]).sum() > 0
        for k, ref in want.items():
            np.testing.assert_allclose(grads[k], ref, rtol=1e-5, atol=1e-7, err_msg=k)


# ---- against the JAX package (its sharded entry points on the 8-device CPU mesh) ----


def test_film_matches_reference_sharded(ranks):
    s, cam = j_tiny_scene()
    ids = np.arange(64, dtype=np.int32)
    jfilm, jrays = j_render_block_sharded(s.compile(), cam, ids, ids // 8, ids % 8, spp=16,
                                          mesh=j_make_mesh(8))
    jfilm = np.asarray(jfilm)
    film, rays = ranks[4][0]["block"]
    # a pixel sums 16 paths: 99% of paths within tolerance leaves 0.99**16 of pixels
    # with none outside (measured: 86% of pixels, means within 0.07%, rays equal)
    close = np.isclose(film, jfilm, rtol=1e-3, atol=1e-4).all(-1).mean()
    assert close >= 0.99**16, close
    np.testing.assert_allclose(film.mean(), jfilm.mean(), rtol=5e-3)
    assert rays == int(jrays)


def test_grads_match_reference_sharded(ranks):
    scene, cam = j_cornell(8, 8)
    cam.max_depth = 6
    ids = np.arange(16, dtype=np.int32)
    jfilm, jgrads = j_render_grads_sharded(scene.compile(), cam, ids, ids // 8, ids % 8, spp=8,
                                           mesh=j_make_mesh(8))
    film, grads = ranks[4][0]["grads"]
    np.testing.assert_allclose(film.mean(), np.asarray(jfilm).mean(), rtol=2e-2)
    for k, got in grads.items():
        ref = np.asarray(jgrads[k])
        err = np.abs(got - ref).sum() / max(np.abs(ref).sum(), 1e-30)
        assert err <= 2e-2, (k, err)
