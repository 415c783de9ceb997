"""Sample-axis sharding over a torch.distributed process group.

Counterpart of ``tpupt/parallel/sharding.py``. One process drives one device (a
JAX mesh becomes a process group), and every process holds the whole scene:

- rank i of an n-rank mesh traces samples [sample0 + i*r*k, sample0 + (i+1)*r*k)
  of the same pixel block through the same streamed wavefront, so the forward pass
  needs no communication (the per-(pixel, sample) radiance depends only on the
  counter RNG: seed, pixel, sample);
- the film is all-reduced once a launch, and in the gradient pass each backward
  segment's gradient chunk is all-reduced as soon as its replay produces it
  (render/diff.py segmented_film_vjp; on CUDA between the launches of its graphs,
  never inside them).

A sharded render equals a one-device render up to the order of the float32 film sum.
The CPU tests run several gloo ranks in spawned processes; the CLI's ``--mesh N``
runs under ``torchrun --nproc-per-node N``.
"""

from __future__ import annotations

import dataclasses
import os

import torch
import torch.distributed as dist


def local_device() -> torch.device:
    """This process's card: cuda:{LOCAL_RANK} (torchrun sets LOCAL_RANK; default 0)."""
    return torch.device(f"cuda:{int(os.environ.get('LOCAL_RANK', '0'))}")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-axis mesh of processes, one device each: the counterpart of a 1-axis
    ``jax.sharding.Mesh``. `group` is None for a mesh of one without torch.distributed,
    whose reduce is the identity."""

    group: object
    size: int
    index: int  # this process's position on the axis
    device: torch.device
    axis_name: str = "samples"

    def all_reduce(self, tensor: torch.Tensor, async_op: bool = False):
        """Sum `tensor` in place over the mesh -> the collective's handle if async_op
        (None for a mesh without a group)."""
        if self.group is None:
            return None
        return dist.all_reduce(tensor, group=self.group, async_op=async_op)

    def barrier(self) -> None:
        if self.group is not None:
            dist.barrier(group=self.group)


def make_mesh(n_devices: int | None = None, device=None) -> Mesh | None:
    """The mesh over the first `n_devices` ranks of the world (default: all of it).

    Without torch.distributed initialised, a mesh of one (n_devices None or 1). The
    device is cuda:{LOCAL_RANK} unless the caller names one. Every rank of the world
    must call this (a smaller mesh is a new group); ranks outside the mesh get None.
    """
    dev = torch.device(device) if device is not None else local_device()
    if not dist.is_initialized():
        if n_devices in (None, 1):
            return Mesh(None, 1, 0, dev)
        raise RuntimeError(
            f"requested a {n_devices}-device mesh but only 1 process is running (launch "
            f"one process a device: torchrun --nproc-per-node {n_devices} ..., which "
            "initialize_distributed() then joins)"
        )
    world, rank = dist.get_world_size(), dist.get_rank()
    n = world if n_devices is None else n_devices
    if world < n:
        raise RuntimeError(
            f"requested a {n}-device mesh but only {world} process(es) are in the "
            "process group (one process drives one device)"
        )
    group = dist.group.WORLD if n == world else dist.new_group(list(range(n)))
    return Mesh(group, n, rank, dev) if rank < n else None


def all_reduce_film(mesh, film, rays):
    """(film [pb,3], rays int) summed over the mesh (film in place, in float32)."""
    n = torch.tensor([rays], dtype=torch.int64, device=film.device)
    mesh.all_reduce(film)
    mesh.all_reduce(n)
    return film, int(n)


def render_block_sharded(compiled, camera, pixel_ids, rows, cols, spp: int, seed: int = 0,
                         mesh: Mesh | None = None):
    """Render one pixel block with the sample axis sharded over the mesh.

    spp must be a multiple of the mesh size. Returns (film sum [pb,3] float32 on the
    scene's device, rays int), both summed over the mesh; every rank gets the same.
    rows/cols are accepted for the reference's signature; the streamed path derives
    them from pixel_ids and the camera width.
    """
    from ..render.graph import launch_graphs
    from ..render.renderer import _chunk_film

    mesh = mesh or make_mesh()
    assert spp % mesh.size == 0, f"spp {spp} must divide over {mesh.size} devices"
    k = spp // mesh.size
    sd = compiled.data
    pix = torch.as_tensor(pixel_ids, dtype=torch.int32, device=sd.device)
    film, rays, _ = _chunk_film(
        sd, camera.init(sd.device), pix, pix.shape[0], mesh.index * k, spp, seed, k=k, r=1,
        max_depth=camera.max_depth, has_lights=compiled.has_lights, width=camera.image_width,
        graphs=launch_graphs(compiled),
    )
    return all_reduce_film(mesh, film.clone(), rays)  # a copy: the graphs' next launch rewrites theirs


def sharded_grad_step(mesh: Mesh, max_depth: int, has_lights: bool):
    """Build the sharded forward+backward step: build(k_per_device) -> step(params,
    sd, cam, pixel_ids, rows, cols, sample0, seed) -> (film sum [pb,3], grads).

    Rank i traces samples [sample0 + i*k, sample0 + (i+1)*k) of every pixel with the
    detached estimator (render/diff.py segmented_film_vjp, cotangent ones); each
    backward segment's gradient chunk is all-reduced as its replay ends, and the film
    once at the end. On CUDA the step runs as CUDA graphs kept on the SceneData (one
    launch of the forward trips a chunk, one of the replays a segment), the collectives
    between the launches; the counterpart of the reference's jitted shard_map step.
    """
    from ..render.diff import segmented_film_vjp

    def build(k_per_device: int):
        def step(params, sd, cam, pixel_ids, rows, cols, sample0, seed):
            pb, dev = pixel_ids.shape[0], pixel_ids.device
            pix = pixel_ids.repeat(k_per_device)
            local = sample0 + mesh.index * k_per_device + torch.repeat_interleave(
                torch.arange(k_per_device, dtype=torch.int32, device=dev), pb
            )
            radiance, grads = segmented_film_vjp(
                params, sd, cam, pix, rows.repeat(k_per_device), cols.repeat(k_per_device),
                local.to(torch.int32), seed, max_depth, has_lights,
                torch.ones((pix.shape[0], 3), dtype=torch.float32, device=dev), mesh=mesh,
            )
            film = radiance.reshape(k_per_device, pb, 3).sum(dim=0)
            mesh.all_reduce(film)
            return film, grads

        return step

    return build


def render_grads_sharded(compiled, camera, pixel_ids, rows, cols, spp: int, seed: int = 0,
                         mesh: Mesh | None = None):
    """Film mean and parameter grads of a pixel block, the sample axis sharded over the
    mesh: (film_mean [pb,3], grads of d(sum_pixels mean_sample radiance)/d params by
    DIFF_FIELDS name), as render_grads with cotangent ones; every rank gets the same."""
    from ..render.diff import init_params

    mesh = mesh or make_mesh()
    assert spp % mesh.size == 0, f"spp {spp} must divide over {mesh.size} devices"
    k = spp // mesh.size
    sd = compiled.data
    dev = sd.device
    step = sharded_grad_step(mesh, camera.max_depth, compiled.has_lights)(k)
    film, grads = step(
        init_params(sd), sd, camera.init(dev),
        *(torch.as_tensor(a, dtype=torch.int32, device=dev) for a in (pixel_ids, rows, cols)),
        0, seed,
    )
    inv = 1.0 / spp
    return film * inv, {name: g * inv for name, g in grads.items()}
